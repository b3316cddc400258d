"""Recording, autosave, boot and merge of the port's StreamingEngine, and the
live CLI's persistence flags.

Against the JAX StreamingEngine on the same weights (through the bridge),
frames and injected clock: recording happens on the same ticks and writes
the same labels.json (file names mapped in order; scores within the 1e-3 that
tests/test_torch_engine.py holds them to), err and rec PNGs within 1 grey
level; autosave fires on the same ticks under the same schedule semantics.
Then tests/test_stream.py's recording, save, merge and int8-boot cases
carried over to the port, and the port's own risks: a continual-learning
step after an asynchronous autosave, a background write that fails, a drain
that fails (at the rss guard and at exit), a save reloaded whole."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_helpers import tiny_config, torch_model_like
from trustedai_cl_vae_ad_tpu_torch.testing import warm_score_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED = {
    "anomaly_score_threshold": 2.0,
    "anomaly_score_method": "zz_count",
    "buffer_record_period_s": 1.0,
    "anomalous_state_period_s": 0.05,
}
SMALL = dict(image=(16, 16, 3), layers=(4,), latent=8, ddf=4, model_type="KurtosisSingle")


def _frames(n=12):
    """40x64 synthetic frames (resized to 32x48 on the device), a static
    scene with sensor noise and a bright blob in frames 8 and 9: the
    sequence tests/test_torch_engine.py holds both engines to."""
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource

    return list(SyntheticSource(width=64, height=40, n_frames=n, anomaly_frames=range(8, 10),
                                motion=0.0, seed=5))


@pytest.fixture(scope="module")
def models():
    from trustedai_cl_vae_ad_tpu.registry import load_model_from_config as jax_load

    config = tiny_config(image=(32, 48, 3))
    jmodel = jax_load(config)
    return config, jmodel, torch_model_like(config, jmodel.params)


def _port_model(seed=0, **kwargs):
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    config = tiny_config(**dict(SMALL, **kwargs))
    return load_model_from_config(config, seed=seed, device="cpu"), config


def _engine(model, config, **kwargs):
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    eng = StreamingEngine(model, config, anomaly_settings=dict(FIXED), **kwargs)
    eng.inference_period_ms = 0.0
    return eng


def _frame(rng, shape=(20, 24, 3)):
    return rng.randint(0, 255, shape, np.uint8)


def _spy_saves(engine, log):
    """Record (frame index, directory) of every save_model_to_dir call."""
    save = engine.save_model_to_dir

    def spy(model_dir, saver=None):
        log.append((engine._frame_i, os.path.basename(model_dir)))
        return save(model_dir, saver=saver)

    engine.save_model_to_dir = spy


def _state(model):
    """Clones of the parameters and of Adam's moments."""
    opt = model.optimizer
    return ({k: v.detach().clone() for k, v in model.params.items()},
            {k: v.detach().clone() for k, v in opt.state_dict()["mu"].items()},
            {k: v.detach().clone() for k, v in opt.state_dict()["nu"].items()},
            opt.count)


def _assert_round_equals(cache, state):
    from trustedai_cl_vae_ad_tpu_torch.train import checkpoint

    params, mu, nu, count = state
    restored = checkpoint.restore_params(cache)
    assert set(restored) == set(params)
    for k, v in params.items():
        assert torch.equal(restored[k], v), k
    opt = checkpoint.restore_optimizer_state(cache)
    assert opt["count"] == count
    for k in mu:
        assert torch.equal(opt["mu"][k], mu[k]) and torch.equal(opt["nu"][k], nu[k]), k


# -- against the JAX engine -----------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True], ids=["plain", "pipelined"])
def test_recording_and_autosave_match_jax_engine(models, tmp_path, pipelined):
    from trustedai_cl_vae_ad_tpu.ops.stream_score import StreamScoreState as JState
    from trustedai_cl_vae_ad_tpu.stream.engine import StreamingEngine as JaxEngine
    from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState as TState
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    config, jmodel, tmodel = models
    engines, saves, recorded, results = {}, {}, {}, {}
    for name, cls in (("jax", JaxEngine), ("port", StreamingEngine)):
        root = tmp_path / name
        (root / "rec").mkdir(parents=True)
        eng = cls(jmodel if name == "jax" else tmodel, config, anomaly_settings=dict(FIXED),
                  pipelined=pipelined, model_cache_dir=str(root / "cache"), autosave_period_s=1.0)
        eng.inference_period_ms = 0.0
        maps, scalars = warm_score_state(32, 48)
        eng.score_state = (JState(jnp.asarray(maps), jnp.asarray(scalars)) if name == "jax"
                           else TState(torch.from_numpy(maps), torch.from_numpy(scalars)))
        eng.begin_recording(str(root / "rec"))
        engines[name], saves[name], recorded[name], results[name] = eng, [], [], []
        _spy_saves(eng, saves[name])
    for i, frame in enumerate(_frames()):
        for name, eng in engines.items():
            eng._frame_i = i
            if i in (2, 9):
                eng.model_changed_flag = True  # as a CL step would
            if i == 5:
                eng.schedule_model_save()  # saves: the model was dirtied at 2
            if i == 7:
                eng.schedule_model_save_override()  # saves though clean
            before = len(eng.anomaly_score_map)
            r = eng.process_frame(frame, now=0.2 * i, tag=i)
            if r is not None:
                results[name].append(r)
            recorded[name].append(len(eng.anomaly_score_map) > before)
            time.sleep(0.002)  # distinct file names (microsecond time stamps)
    for name, eng in engines.items():
        eng._frame_i = "end"
        before = len(eng.anomaly_score_map)
        eng.flush(now=0.2 * 12)
        recorded[name].append(len(eng.anomaly_score_map) > before)
    assert recorded["jax"] == recorded["port"] and sum(recorded["port"]) >= 3
    # the first frame that reaches the cycle (0, or 1 in pipelined mode, whose first call
    # returns early) seeds the period's clock and consumes the starting flag on a clean
    # model; 5: the schedule, on the model dirtied at 2; 7: forced; then the period's next
    # firing after 9 dirtied the model
    assert saves["jax"] == saves["port"], saves
    assert [i for i, _ in saves["port"]] == ([5, 7, 11] if pipelined else [5, 7, 10])
    labels = {name: json.load(open(eng.terminate_recording())) for name, eng in engines.items()}
    j, t = labels["jax"], labels["port"]
    assert j["info"] == t["info"] and j["categories"] == t["categories"] == []
    names = dict(zip([im["file_name"] for im in t["images"]],
                     [im["file_name"] for im in j["images"]]))
    assert [dict(im, file_name=names[im["file_name"]]) for im in t["images"]] == j["images"]
    assert len(t["annotations"]) == len(j["annotations"]) == len(t["images"])
    for a, b in zip(t["annotations"], j["annotations"]):
        (tn, ts), = a.items()
        (jn, js), = b.items()
        assert names[tn] == jn and (np.isnan(ts) == np.isnan(js))
        if not np.isnan(ts):
            assert abs(ts - js) <= 1e-3, (tn, ts, js)
    jdir, tdir = engines["jax"].record_instance_dir, engines["port"].record_instance_dir
    for tn, jn in names.items():
        for sub, tol in (("frames", 0), ("err", 1), ("rec", 1)):
            a = np.asarray(Image.open(os.path.join(tdir, sub, tn))).astype(int)
            b = np.asarray(Image.open(os.path.join(jdir, sub, jn))).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= tol, (sub, tn)
    assert os.path.isdir(os.path.join(tdir, "model", "encoder"))


def test_schedule_model_save_semantics_match_jax_engine(models, tmp_path):
    """The autosave cycle step by step in both engines: the period timer,
    the consumed schedule flag, save iff dirty, the override."""
    from trustedai_cl_vae_ad_tpu.stream.engine import StreamingEngine as JaxEngine
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    config, jmodel, tmodel = models
    trace = {}
    for name, cls, model in (("jax", JaxEngine, jmodel), ("port", StreamingEngine, tmodel)):
        eng = cls(model, config, model_cache_dir=str(tmp_path / name), autosave_period_s=2.0)
        calls = []
        eng.save_model_to_dir = lambda d, saver=None, c=calls: c.append(d)
        steps = []
        for now, action in ((0.0, None), (0.5, "dirty"), (1.0, None), (2.0, None),
                            (2.5, "schedule"), (3.0, "dirty"), (3.5, "schedule"),
                            (4.0, "override"), (6.5, "dirty")):
            if action == "dirty":
                eng.model_changed_flag = True
            elif action == "schedule":
                eng.schedule_model_save()
            elif action == "override":
                eng.schedule_model_save_override()
            eng._maybe_autosave(now)
            steps.append((now, len(calls), eng.schedule_model_save_flag, eng.model_changed_flag))
        trace[name] = steps
    assert trace["port"] == trace["jax"]
    assert [n for _t, n, _s, _d in trace["port"]] == [0, 0, 0, 1, 1, 1, 2, 3, 4]


# -- carried over from tests/test_stream.py ----------------------------------------------------

def test_engine_recording_and_labels(tmp_path):
    model, config = _port_model()
    engine = _engine(model, config)
    rec_dir = tmp_path / "recordings"
    rec_dir.mkdir()
    engine.record_period_ms = 0.0
    engine.begin_recording(str(rec_dir))
    for f in np.random.RandomState(4).randint(0, 255, (3, 20, 24, 3), np.uint8):
        engine.process_frame(f)
    labels_path = engine.terminate_recording()
    assert labels_path and os.path.exists(labels_path) and not engine.recording_flag
    with open(labels_path) as fh:
        labels = json.load(fh)
    inst = os.path.dirname(labels_path)
    n = len(labels["images"])
    assert n == 3 and len(labels["annotations"]) == n  # per-frame anomaly scores
    for sub in ("frames", "err", "heatmap", "overlay", "rec"):
        assert len(os.listdir(os.path.join(inst, sub))) == n
    assert os.path.isdir(os.path.join(inst, "model", "encoder"))


def test_recorded_overlay_blends_input_frame(tmp_path):
    """Overlay stream = 0.5 jet(err) + 0.5 model-size INPUT frame (not the
    reconstruction), the frame resized on the host with PIL bilinear."""
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import overlay_heatmap

    model, config = _port_model()
    engine = _engine(model, config)
    rec_dir = tmp_path / "rec_overlay"
    rec_dir.mkdir()
    engine.record_period_ms = 0.0
    engine.begin_recording(str(rec_dir))
    frame = np.random.RandomState(8).randint(0, 255, (20, 24, 3), np.uint8)
    result = engine.process_frame(frame)
    inst = engine.record_instance_dir
    engine.terminate_recording()
    (name,) = os.listdir(os.path.join(inst, "overlay"))
    got = np.asarray(Image.open(os.path.join(inst, "overlay", name)))
    base = np.asarray(Image.fromarray(frame).resize((engine.width, engine.height), Image.BILINEAR))
    np.testing.assert_array_equal(got, overlay_heatmap(result.norm_err_u8, base))


@pytest.mark.parametrize("frame_shape", [(12, 10, 1), (8, 6, 1)], ids=["resized", "model-size"])
def test_record_frame_artifacts_single_channel(tmp_path, frame_shape):
    """Single-channel models stream (H, W, 1) frames and reconstructions: the
    five PNG streams are written in grayscale, through the host resize too;
    the files equal the JAX recorder's."""
    from trustedai_cl_vae_ad_tpu.stream.engine import record_frame_artifacts as jax_record
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import record_frame_artifacts

    rng = np.random.RandomState(0)
    frame = rng.randint(0, 255, frame_shape, np.uint8)
    norm = rng.randint(0, 255, (8, 6), np.uint8)
    rec = rng.randint(0, 255, (8, 6, 1), np.uint8)
    for name, fn in (("port", record_frame_artifacts), ("jax", jax_record)):
        inst = str(tmp_path / name)
        for sub in ("frames", "err", "heatmap", "overlay", "rec"):
            os.makedirs(os.path.join(inst, sub))
        fn(inst, "f0.png", frame, norm, rec, height=8, width=6)
    for sub, mode in (("frames", "L"), ("err", "L"), ("heatmap", "RGB"), ("overlay", "RGB"),
                      ("rec", "L")):
        img = Image.open(os.path.join(tmp_path, "port", sub, "f0.png"))
        assert img.mode == mode, (sub, img.mode)
        assert ((tmp_path / "port" / sub / "f0.png").read_bytes()
                == (tmp_path / "jax" / sub / "f0.png").read_bytes()), sub


def test_save_model_with_cam_info(tmp_path):
    from trustedai_cl_vae_ad_tpu_torch.config import load_config

    model, config = _port_model()
    engine = _engine(model, config)
    engine.cam_info = {"name": "cam0", "url": "rtsp://example", "fps": 20}
    out = engine.save_model_to_dir(str(tmp_path / "saved"))
    cfg = load_config(os.path.join(out, "config.yml"))
    assert cfg["cam_info"]["name"] == "cam0" and cfg["model"] == config["model"]
    assert os.path.isdir(os.path.join(out, "encoder"))
    assert not os.path.exists(os.path.join(out, "replay_buffer_paths.csv"))
    dated = engine.save_model_to_dir_by_date(str(tmp_path / "dated"))
    assert os.path.basename(dated).startswith("date_") and os.path.isdir(
        os.path.join(dated, "decoder"))


def _labelled_sources(tmp_path, sizes):
    for name, ids in sizes:
        d = tmp_path / name / "frames"
        d.mkdir(parents=True)
        (d / f"{name}0.png").write_bytes(b"png")
        labels = {"info": {}, "categories": [], "annotations": [],
                  "images": [{"id": i, "width": 4, "height": 4, "file_name": f"{name}{i}.png"}
                             for i in ids]}
        (tmp_path / name / "labels.json").write_text(json.dumps(labels))


def test_combine_datasets(tmp_path):
    from trustedai_cl_vae_ad_tpu.stream.engine import combine_datasets as jax_combine
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import combine_datasets

    _labelled_sources(tmp_path, (("a", [0, 1]), ("b", [0])))
    outs = []
    for name, fn in (("merged", combine_datasets), ("jax_merged", jax_combine)):
        (tmp_path / name).mkdir()
        with open(fn([str(tmp_path / "a"), str(tmp_path / "b")], str(tmp_path / name))) as f:
            outs.append(json.load(f))
    assert len(outs[0]["images"]) == 3 and outs[0] == outs[1]
    assert (tmp_path / "merged" / "frames" / "a0.png").is_file()
    assert (tmp_path / "merged" / "frames" / "b0.png").is_file()
    with pytest.raises(FileNotFoundError, match="no labels.json"):
        combine_datasets([str(tmp_path / "merged" / "frames")], str(tmp_path / "merged"))
    with pytest.raises(NotADirectoryError):
        combine_datasets([str(tmp_path / "a")], str(tmp_path / "nowhere"))


def test_combine_datasets_cli(tmp_path):
    """--combine-datasets merges and exits without loading a model or asking
    for a device (no --device: the default cuda is not checked)."""
    _labelled_sources(tmp_path, (("a", [0, 1]), ("b", [0, 1, 2])))
    dest = tmp_path / "merged"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "camera_streamer_torch.py"),
         "--combine-datasets", str(tmp_path / "a"), str(tmp_path / "b"),
         "--combine-dest", str(dest)],
        capture_output=True, text=True, timeout=180, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert "Combined 2 datasets" in proc.stdout
    with open(dest / "labels.json") as f:
        assert len(json.load(f)["images"]) == 5
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "camera_streamer_torch.py"),
         "--combine-datasets", str(tmp_path / "a")],
        capture_output=True, text=True, timeout=180, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 2 and "requires --combine-dest" in proc.stderr


def test_schedule_model_save_semantics(tmp_path):
    """schedule_model_save saves at the next tick IFF dirty (the flag is
    consumed either way); the override saves even when clean."""
    model, config = _port_model()
    engine = _engine(model, config)
    cache = tmp_path / "cache"
    cache.mkdir()
    engine.model_cache_dir = str(cache)
    engine.model_changed_flag = False
    engine.schedule_model_save_flag = False
    engine.autosave_period_s = 1e9
    frame = np.random.RandomState(9).randint(0, 255, (20, 24, 3), np.uint8)
    engine.process_frame(frame)
    assert not os.path.exists(cache / "encoder")  # nothing scheduled

    engine.schedule_model_save()  # clean model: consumed, no save
    engine.process_frame(frame)
    assert not os.path.exists(cache / "encoder")
    assert engine.schedule_model_save_flag is False

    engine.schedule_model_save_override()  # forced: saves even when clean
    engine.process_frame(frame)
    assert os.path.isdir(cache / "encoder")
    assert engine.schedule_model_save_flag is False
    assert engine.model_changed_flag is False


def test_engine_int8_checkpoint_boot(tmp_path, monkeypatch):
    """load_engine_from_directory(quantize=True, int8_checkpoint_boot=True)
    boots from <logdir>/quantized without float parameters and scores
    bit-identically to the quantize-at-load engine; CL controls raise; a
    recording snapshot of an int8 boot persists the quantized tree and boots
    again."""
    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.ops import quant
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import load_engine_from_directory

    monkeypatch.setenv("TCVAE_QUANT_MIN_ELEMS", "0")
    model, config = _port_model()
    d = str(tmp_path / "m")
    model.save_model(d, include_optimizer=False)
    save_config(config, os.path.join(d, "config.yml"))

    ref = load_engine_from_directory(d, quantize=True, device="cpu")  # quantize-at-load
    assert ref.model.params is not None and ref.quantized
    no_sidecar = load_engine_from_directory(d, quantize=True, int8_checkpoint_boot=True,
                                            device="cpu")
    assert no_sidecar.model.params is not None  # no quantized/ yet: the float boot
    quant.save_quantized_checkpoint(d, quant.quantize_params(model.core, model.params))
    int8 = load_engine_from_directory(d, quantize=True, int8_checkpoint_boot=True, device="cpu")
    assert int8.model.params is None  # the float tree never materialized
    ref.inference_period_ms = int8.inference_period_ms = 0.0

    rng = np.random.RandomState(7)
    for _ in range(4):
        f = _frame(rng, (16, 16, 3))
        r_ref, r_int8 = ref.process_frame(f), int8.process_frame(f)
        for a, b in ((r_ref.score, r_int8.score), (r_ref.pixel_count, r_int8.pixel_count)):
            assert (np.isnan(a) and np.isnan(b)) or a == b  # the same int8 tree, the same bits

    with pytest.raises(RuntimeError, match="int8 checkpoint"):
        int8.set_learning_rate(1e-3)
    int8.enable_cont_learning = True
    int8.continuous_learning_period_ms = 0.0
    with pytest.raises(RuntimeError, match="int8 checkpoint"):
        int8.process_frame(_frame(rng, (16, 16, 3)))
    int8.enable_cont_learning = False

    rec = str(tmp_path / "rec")
    os.makedirs(rec)
    int8.record_period_ms = 0.0
    int8.begin_recording(rec)
    for _ in range(2):
        int8.process_frame(_frame(rng, (16, 16, 3)))
    labels_path = int8.terminate_recording()
    assert labels_path and os.path.exists(labels_path)
    snap = os.path.join(os.path.dirname(labels_path), "model")
    assert quant.has_quantized_checkpoint(snap)
    assert not os.path.exists(os.path.join(snap, "encoder"))
    again = load_engine_from_directory(snap, quantize=True, int8_checkpoint_boot=True,
                                       device="cpu")
    again.inference_period_ms = 0.0
    r = again.process_frame(_frame(rng, (16, 16, 3)))
    assert again.model.params is None and np.isfinite(r.pixel_count)


def test_int8_boot_from_a_cl_cache_reports_the_stale_sidecar(tmp_path, monkeypatch, capsys):
    """After continual learning on a quantized engine, the cache's float round
    is newer than the quantized/ sidecar in it: an int8 boot from the cache
    says the sidecar is stale (quantized_staleness)."""
    from trustedai_cl_vae_ad_tpu_torch.ops import quant
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import load_engine_from_directory

    monkeypatch.setenv("TCVAE_QUANT_MIN_ELEMS", "0")
    model, config = _port_model()
    cache = str(tmp_path / "cache")
    eng = _engine(model, config, quantize=True, model_cache_dir=cache,
                  continuous_learning_period_ms=0.0)
    eng.schedule_model_save_flag = False
    eng.save_model_to_dir(cache)
    quant.save_quantized_checkpoint(cache, quant.quantize_params(model.core, model.params))
    assert quant.quantized_staleness(cache) is None
    eng.enable_cont_learning = True
    eng.process_frame(_frame(np.random.RandomState(3)))  # a CL step: dirty
    eng.schedule_model_save()
    eng.process_frame(_frame(np.random.RandomState(4)))  # CL again, then the save
    assert not eng.model_changed_flag and eng.cl_epochs == 2
    assert quant.quantized_staleness(cache)[0] == "provenance_mismatch"
    capsys.readouterr()
    booted = load_engine_from_directory(cache, quantize=True, int8_checkpoint_boot=True,
                                        device="cpu")
    assert booted.model.params is None
    out = capsys.readouterr().out
    assert "int8 boot" in out and "WARNING" in out and "DIFFERENT float checkpoint" in out


# -- the port's own risks ---------------------------------------------------------------------

def test_cl_step_after_async_autosave_leaves_the_round_unchanged(tmp_path):
    """An async autosave returns once its state is copied; the CL step that
    follows updates parameters and moments in place, and the committed round
    still holds the state at the save, bit for bit."""
    from trustedai_cl_vae_ad_tpu_torch.train import checkpoint

    model, config = _port_model()
    cache = str(tmp_path / "cache")
    eng = _engine(model, config, model_cache_dir=cache, async_autosave=True,
                  continuous_learning_period_ms=0.0)
    eng.enable_cont_learning = True
    at_save = []
    save = eng.save_model_to_dir

    def spy(model_dir, saver=None):
        at_save.append(_state(model))
        return save(model_dir, saver=saver)

    eng.save_model_to_dir = spy
    rng = np.random.RandomState(5)
    eng.process_frame(_frame(rng), now=1.0)  # a CL step, then the autosave (the flag starts set)
    assert len(at_save) == 1 and eng._async_saver is not None and not eng.model_changed_flag
    eng.process_frame(_frame(rng), now=2.0)  # a CL step while the round may still be written
    eng.process_frame(_frame(rng), now=3.0)
    assert eng.cl_epochs == 3 and model.optimizer.count == 3
    eng.drain_autosaves()
    assert eng._async_saver is None
    assert [n for n, _ in checkpoint._complete_rounds(os.path.join(cache, "rounds"))] == [1]
    _assert_round_equals(cache, at_save[0])
    params = at_save[0][0]
    assert any(not torch.equal(model.params[k], params[k]) for k in params)  # CL moved them


def _failing_writer(monkeypatch, failures):
    """Make the background writer's payload writes fail ``failures`` times
    (None: always); the synchronous save, on the calling thread, still writes."""
    from trustedai_cl_vae_ad_tpu_torch.train import checkpoint

    write = checkpoint._write_payload
    left = {"n": failures}

    def write_or_fail(obj, staging, sub):
        if threading.current_thread().name == "checkpoint-writer" and left["n"] != 0:
            if left["n"] is not None:
                left["n"] -= 1
            raise OSError("disk full (simulated)")
        return write(obj, staging, sub)

    monkeypatch.setattr(checkpoint, "_write_payload", write_or_fail)


def test_failed_background_write_redirties_and_is_retried(tmp_path, monkeypatch, capsys):
    """A failed background write surfaces at the next autosave: the model is
    dirty again, nothing was committed, and the following schedule commits a
    round."""
    from trustedai_cl_vae_ad_tpu_torch.train import checkpoint

    _failing_writer(monkeypatch, 1)
    model, config = _port_model()
    cache = str(tmp_path / "cache")
    rounds = os.path.join(cache, "rounds")
    eng = _engine(model, config, model_cache_dir=cache, async_autosave=True,
                  continuous_learning_period_ms=0.0)
    eng.enable_cont_learning = True
    rng = np.random.RandomState(6)
    eng.process_frame(_frame(rng), now=1.0)  # CL + the autosave whose write fails
    assert not eng.model_changed_flag
    eng.schedule_model_save()
    eng.process_frame(_frame(rng), now=2.0)  # CL; the save raises the previous round's error
    out = capsys.readouterr().out
    assert "autosave failed" in out and "disk full" in out
    assert eng.model_changed_flag and checkpoint._complete_rounds(rounds) == []
    eng.enable_cont_learning = False  # no CL step changes the model from here on
    at_retry = _state(model)
    eng.schedule_model_save()
    eng.process_frame(_frame(rng), now=3.0)  # retried
    assert not eng.model_changed_flag
    eng.drain_autosaves()
    assert [n for n, _ in checkpoint._complete_rounds(rounds)] == [1]
    _assert_round_equals(cache, at_retry)


@pytest.mark.parametrize("where", ["guard", "exit"])
def test_drain_failure_still_saves_synchronously(tmp_path, monkeypatch, capsys, where):
    """The reference's drain hole: when the drain raises, the failed round's
    CL state must still reach the cache. The port marks the model dirty on a
    failed drain and saves synchronously, at the rss guard and at exit."""
    from trustedai_cl_vae_ad_tpu_torch.stream import run
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource

    _failing_writer(monkeypatch, None)  # every background write fails
    model, config = _port_model()
    cache = str(tmp_path / "cache")
    # one CL step, in frame 0, and its async autosave: the model is clean after it, so
    # only the failed drain can get that step into the cache
    eng = _engine(model, config, model_cache_dir=cache, async_autosave=True,
                  continuous_learning_period_ms=500.0)
    eng.enable_cont_learning = True
    n_frames = run.RSS_POLL_TICKS + 5 if where == "guard" else 3
    readings = iter([0.0] + [1e9] * 3)  # the guard trips at its second poll
    monkeypatch.setattr(run, "rss_mb", lambda: next(readings, 1e9))
    summary = run.run_stream(eng, SyntheticSource(width=24, height=20, n_frames=n_frames, seed=1),
                             max_rss_mb=100.0 if where == "guard" else None,
                             clock=lambda n: 1.0 + 0.001 * n, log=print)
    out = capsys.readouterr().out
    assert "autosave drain failed" in out and "disk full" in out
    assert summary["rss_tripped"] == (where == "guard")
    assert summary["frames"] == (run.RSS_POLL_TICKS if where == "guard" else 3)
    assert eng.cl_epochs == 1 and not eng.model_changed_flag and eng._async_saver is None
    _assert_round_equals(cache, _state(model))  # the CL step is in the cache


def test_save_then_load_engine_restores_everything(tmp_path):
    """save_model_to_dir, then load_engine_from_directory: equal parameters,
    Adam moments and step count, replay paths and buffer, and cam_info."""
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import load_engine_from_directory

    model, config = _port_model()
    eng = _engine(model, config, cam_info={"name": "gate", "fps": 15},
                  continuous_learning_period_ms=0.0, replay_capacity=16)
    rng = np.random.RandomState(7)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"replay{i}.png")
        Image.fromarray(_frame(rng)).save(p)
        paths.append(p)
    assert eng.load_replay_buffer_from_filelist(paths + [str(tmp_path / "gone.png")]) == 3
    eng.enable_cont_learning = True
    for i in range(2):
        eng.process_frame(_frame(rng), now=float(i + 1))
    d = str(tmp_path / "saved")
    eng.save_model_to_dir(d)
    state = _state(model)
    loaded = load_engine_from_directory(d, device="cpu", anomaly_settings=dict(FIXED))
    assert loaded.cam_info == {"name": "gate", "fps": 15}
    assert loaded.replay_buffer_paths == eng.replay_buffer_paths == paths
    assert loaded.replay_n == 3 and torch.equal(loaded.replay_buffer[:3], eng.replay_buffer[:3])
    got = _state(loaded.model)
    assert got[3] == state[3] == 2
    for a, b in zip(got[:3], state[:3]):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    loaded.inference_period_ms = 0.0
    frame = _frame(rng)
    eng.enable_cont_learning = False
    maps, scalars = warm_score_state(16, 16)
    from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState

    for e in (eng, loaded):
        e.score_state = StreamScoreState(torch.from_numpy(maps.copy()),
                                         torch.from_numpy(scalars.copy()))
    a, b = eng.process_frame(frame, now=100.0), loaded.process_frame(frame, now=100.0)
    assert a.pixel_count == b.pixel_count
    np.testing.assert_array_equal(a.reconstruction_u8, b.reconstruction_u8)


# -- the CLI ------------------------------------------------------------------------------------

def _saved_logdir(tmp_path):
    from trustedai_cl_vae_ad_tpu_torch.config import save_config

    model, config = _port_model(image=(8, 8, 3), layers=(2,), latent=4, ddf=2)
    d = str(tmp_path / "model")
    model.save_model(d, include_optimizer=False)
    save_config(config, os.path.join(d, "config.yml"))
    return d, model


def test_help_lists_every_option_of_the_reference_cli(monkeypatch):
    """camera_streamer_torch.py --help offers every option of
    camera_streamer.py, --mesh included, with the same defaults."""
    import re

    import camera_streamer
    import camera_streamer_torch

    def options(script):
        proc = subprocess.run([sys.executable, os.path.join(REPO, script), "--help"],
                              capture_output=True, text=True, timeout=120, cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, proc.stderr
        return set(re.findall(r"(?<![\w-])(--?[a-z][a-z-]*)", proc.stdout))

    reference, port = options("camera_streamer.py"), options("camera_streamer_torch.py")
    assert {"--rtsp-override", "--rtsp-overide", "-r", "--max-rss-mb"} <= reference
    assert reference <= port, reference - port
    monkeypatch.setattr(sys, "argv", ["camera_streamer.py", "-m", "x"])
    ref_args = vars(camera_streamer.get_args())
    port_args = vars(camera_streamer_torch.get_args(["-m", "x", "--device", "cpu"]))
    assert "mesh" in ref_args
    for key, value in ref_args.items():
        assert port_args[key] == value, key
    assert port_args["model_cache_dir"] == "model_cache"
    assert port_args["autosave_period_s"] == 300.0


def test_camera_streamer_sigterm_finalizes_recording(tmp_path):
    """SIGTERM on the streaming CLI runs the clean shutdown: the recording
    closes with labels.json and a model snapshot."""
    d, _ = _saved_logdir(tmp_path)
    rec = tmp_path / "recdir"
    rec.mkdir()
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "camera_streamer_torch.py"), "--device", "cpu",
         "--source", "synthetic", "-m", d, "-r", str(rec)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=str(tmp_path))
    try:
        deadline = time.time() + 180
        instance = None
        while time.time() < deadline:
            dirs = sorted(os.listdir(rec))
            if dirs:
                frames = os.path.join(rec, dirs[0], "frames")
                if os.path.isdir(frames) and os.listdir(frames):
                    instance = os.path.join(rec, dirs[0])
                    break
            if proc.poll() is not None:
                break
            time.sleep(0.2)
        assert proc.poll() is None, f"streamer exited early:\n{proc.stdout.read()}"
        assert instance is not None, "recording never started"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-600:]
    assert os.path.exists(os.path.join(instance, "labels.json")), out[-600:]
    assert os.path.isdir(os.path.join(instance, "model", "encoder"))
    assert not os.path.exists(tmp_path / "model_cache")  # nothing dirtied the model


def test_max_rss_guard_exits_3_with_the_cl_state_in_the_cache(tmp_path, monkeypatch, capsys):
    """--max-rss-mb: when the host's memory passes the limit (read here
    through a stand-in of rss_mb: below at the first poll, above at the
    second), the CLI saves the dirty CL state to the model cache, ends the
    run as usual and exits 3. The default metrics directory is
    <model-cache-dir>/metrics."""
    import camera_streamer_torch
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory
    from trustedai_cl_vae_ad_tpu_torch.stream import run

    d, model = _saved_logdir(tmp_path)
    cache = tmp_path / "cache"
    readings = iter([0.0])
    monkeypatch.setattr(run, "rss_mb", lambda: next(readings, 1e9))
    monkeypatch.setattr(run.StopRequest, "install", lambda self: None)
    with pytest.raises(SystemExit) as exc:
        camera_streamer_torch.main(["--device", "cpu", "--source", "synthetic", "-m", d, "-c",
                                    "--model-cache-dir", str(cache), "--max-frames", "200",
                                    "--max-rss-mb", "100"])
    assert exc.value.code == run.RSS_EXIT_CODE == 3
    out = capsys.readouterr().out
    assert "exceeded --max-rss-mb" in out and "Saved Model to" in out
    assert "processed 25 frames" in out
    cached, _ = load_model_from_directory(str(cache), device="cpu", restore_optimizer=True)
    assert cached.optimizer is not None and cached.optimizer.count >= 1
    assert any(not torch.equal(cached.params[k], v) for k, v in model.params.items())
    records = (cache / "metrics" / "metrics.jsonl").read_text().splitlines()
    assert len(records) == cached.optimizer.count and "cl/loss" in json.loads(records[0])
