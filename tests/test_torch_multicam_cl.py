"""Fleet continual learning, per-camera recording and autosave of the port's
MultiCameraEngine.

One fleet CL step against the JAX MultiCameraEngine on the same weights
(through the bridge), ticks with a dropped camera and the same latent noise
(the JAX step's, passed to the port explicitly, as
tests/test_torch_engine_cl.py does): loss dicts at rtol 1e-4 / atol 1e-6,
parameters within that file's per-step bound (Adam turns a rounding-noise
gradient into a full step, so a few entries may differ by up to lr). Then
tests/test_multicam.py's fleet CL, recording and autosave cases carried over
to the port, and the fleet CLI end to end on the CPU."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_helpers import (
    LOSS_KEYS_BY_TYPE,
    next_jax_eps,
    paired_models,
    tiny_config,
)
from trustedai_cl_vae_ad_tpu_torch.bridge import params_to_flax
from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = {"anomaly_score_threshold": 2.0, "anomaly_score_method": "zz_count",
            "buffer_record_period_s": 1.0, "anomalous_state_period_s": 0.05}
CONFIG = tiny_config(image=(16, 16, 3), layers=(4,), latent=4, ddf=4,
                     model_type="KurtosisSingle")


def _model(seed=0):
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    return load_model_from_config(CONFIG, seed=seed, device="cpu")


def _fleet(model=None, n_streams=2, **kwargs):
    return MultiCameraEngine(model if model is not None else _model(), CONFIG,
                             n_streams=n_streams, anomaly_settings=dict(SETTINGS), **kwargs)


def _frames(rng, k, shape=(16, 16, 3)):
    return [rng.randint(0, 255, shape, np.uint8) for _ in range(k)]


def _inject_eps(model, box):
    """Make the port's CL step take the latent noise in ``box['eps']``."""
    step = model.train_step_and_run

    def with_eps(x, eps=None, weights=None):
        return step(x, eps=torch.from_numpy(box["eps"]), weights=weights)

    model.train_step_and_run = with_eps


def _write_replay(tmp_path, imgs):
    paths = []
    for i, img in enumerate(imgs):
        p = str(tmp_path / f"replay{i}.png")
        Image.fromarray(img).save(p)
        paths.append(p)
    listfile = str(tmp_path / "replay.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(paths) + "\n")
    return listfile


def _leaves(tree):
    for part in ("encoder", "decoder"):
        for layer, leaves in tree[part].items():
            for leaf, arr in leaves.items():
                yield f"{part}/{layer}/{leaf}", np.asarray(arr)


def _manual_step(model, stacked, weights, eps):
    """One step by hand with the port's pieces: the weighted loss of the
    model's type, autograd, Adam."""
    model.compile()
    loss = model.core.compute_loss(stacked, training=True, eps=eps, weights=weights)
    grads = torch.autograd.grad(loss["loss"], model.optimizer.params)
    model.optimizer.step(list(grads))
    return {k: float(v.detach()) for k, v in loss.items()}


# -- against the JAX engine -----------------------------------------------------------------

@pytest.mark.parametrize("replay", [False, True], ids=["ring", "replay"])
def test_fleet_cl_step_matches_jax_engine(tmp_path, replay):
    from trustedai_cl_vae_ad_tpu.stream.multicam import MultiCameraEngine as JaxMulti

    jmodel, tmodel = paired_models(CONFIG, seed=2, compile=False)
    kwargs = dict(n_streams=2, anomaly_settings=dict(SETTINGS), cl_ring_ticks=2,
                  replay_capacity=4)
    j, t = JaxMulti(jmodel, CONFIG, **kwargs), MultiCameraEngine(tmodel, CONFIG, **kwargs)
    rng = np.random.RandomState(3)
    if replay:
        listfile = _write_replay(tmp_path, _frames(rng, 3, (20, 24, 3)))
        assert j.load_replay_buffer_from_file(listfile) == t.load_replay_buffer_from_file(
            listfile) == 3
        np.testing.assert_allclose(t.replay_buffer.numpy(), np.asarray(j.replay_buffer),
                                   atol=1e-5)
    box = {}
    _inject_eps(t.model, box)
    for e in (j, t):
        e.enable_cont_learning = True
    ticks = [_frames(rng, 2, (20, 24, 3)) for _ in range(4)]
    ticks[1][1] = None  # camera 1 drops tick 1: its row weighs 0
    rows = 4 + (4 if replay else 0)
    stepped = []
    for i, (tick, now) in enumerate(zip(ticks, (0.1, 0.2, 1.0, 1.2))):
        box["eps"] = next_jax_eps(j.model, rows)
        a, b = j.process_frames(tick, now=now), t.process_frames(tick, now=now)
        for ra, rb in zip(a, b):
            assert (ra is None) == (rb is None)
            if ra is not None:
                assert abs(ra.pixel_count - rb.pixel_count) <= 2
                assert np.abs(ra.reconstruction_u8.astype(int)
                              - rb.reconstruction_u8.astype(int)).max() <= 1
        if t.cl_epochs > len(stepped):
            stepped.append(i)
    assert stepped == [2] and j.cl_epochs == t.cl_epochs == 1
    np.testing.assert_array_equal(t._cl_valid, j._cl_valid)
    np.testing.assert_allclose(t._cl_ring.numpy(), np.asarray(j._cl_ring), rtol=1e-5, atol=1e-5)
    a, b = j.last_epoch_loss, t.last_epoch_loss
    assert set(b) == set(a) == set(LOSS_KEYS_BY_TYPE["KurtosisSingle"])
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6, err_msg=k)
    lr = CONFIG["training"]["learning_rate"]
    after_j = dict(_leaves(jax.device_get(j.model.params)))
    after_t = dict(_leaves(params_to_flax(t.model.params)))
    for name, ref in after_j.items():
        np.testing.assert_allclose(after_t[name], ref, rtol=0, atol=0.05 * lr, err_msg=name)
        assert (np.abs(after_t[name] - ref) <= 1e-5).mean() > 0.99, name


# -- carried over from tests/test_multicam.py ------------------------------------------------

def test_cl_step_matches_manual():
    """Fleet CL = ONE gradient step on the union ring: the parameters after
    the engine's step equal a step by hand on the stacked (ticks x streams)
    batch with the same latent noise."""
    multi = _fleet(_model(), cl_ring_ticks=2)
    multi.enable_cont_learning = True
    eps = np.random.RandomState(1).randn(4, CONFIG["model"]["latent_dimensions"]).astype(
        np.float32)
    _inject_eps(multi.model, {"eps": eps})
    rng = np.random.RandomState(7)
    ticks = [_frames(rng, 2) for _ in range(3)]
    # period 500 ms: ticks at 0.1/0.2 only fill the ring; the tick at 1.0 steps
    multi.process_frames(ticks[0], now=0.1)
    multi.process_frames(ticks[1], now=0.2)
    multi.process_frames(ticks[2], now=1.0)
    assert multi.cl_epochs == 1 and np.isfinite(multi.last_epoch_loss["loss"])

    model_b = _model()
    # ring slots at the step: slot 0 = tick 2 (it overwrote tick 0), slot 1 = tick 1
    stacked = torch.from_numpy(np.stack(ticks[2] + ticks[1]).astype(np.float32) / 255.0)
    want = _manual_step(model_b, stacked, torch.ones(4), torch.from_numpy(eps))
    for k, v in want.items():
        np.testing.assert_allclose(multi.last_epoch_loss[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    for k, v in model_b.params.items():
        torch.testing.assert_close(multi.model.params[k], v, rtol=1e-4, atol=1e-6)


def test_cl_masks_dropped_streams():
    """Dropped frames weigh 0: a step on [frame, None] ticks equals a step on
    the valid rows alone; an all-dropped ring never steps."""
    multi = _fleet(_model(), cl_ring_ticks=2)
    multi.enable_cont_learning = True
    multi.process_frames([None, None], now=1.0)  # the cadence fires, but no row is valid
    assert multi.cl_epochs == 0 and multi.last_epoch_loss is None
    assert multi.model.optimizer is not None  # the first enabled tick allocated it

    rng = np.random.RandomState(8)
    eps = np.random.RandomState(2).randn(4, 4).astype(np.float32)
    _inject_eps(multi.model, {"eps": eps})
    f0, f1 = _frames(rng, 2)
    multi.process_frames([f0, None], now=1.1)
    multi.process_frames([f1, None], now=2.0)  # steps with half the rows
    assert multi.cl_epochs == 1 and np.isfinite(multi.last_epoch_loss["loss"])
    np.testing.assert_array_equal(multi._cl_valid, [[1, 0], [1, 0]])
    # the ring's rows: slot 0 = [f1, 0] (it overwrote the all-dropped tick), slot 1 = [f0, 0]
    valid = torch.from_numpy(np.stack([f1, f0]).astype(np.float32) / 255.0)
    want = _manual_step(_model(), valid, torch.ones(2), torch.from_numpy(eps[[0, 2]]))
    for k in ("loss", "mse"):
        np.testing.assert_allclose(multi.last_epoch_loss[k], want[k], rtol=1e-5, err_msg=k)


def test_cl_learns_static_fleet():
    """The shared weights fit the union of two static scenes: the loss falls
    over the steps, and the serving forward reads the trained weights."""
    multi = _fleet(_model(), cl_ring_ticks=2)
    multi.enable_cont_learning = True
    multi.set_learning_rate(1e-3)
    scene = _frames(np.random.RandomState(9), 2)
    fixed = torch.full((1, 16, 16, 3), 0.5)
    with torch.inference_mode():
        rec0 = multi._forward(multi._serve_params, fixed).clone()
    losses = []
    for t in range(12):
        multi.process_frames(list(scene), now=float(t))  # period 500 ms: steps from tick 1 on
        if multi.last_epoch_loss is not None:
            losses.append(multi.last_epoch_loss["loss"])
    assert multi.cl_epochs == len(losses) == 11 and losses[-1] < losses[0], losses
    with torch.inference_mode():
        rec1 = multi._forward(multi._serve_params, fixed)
    assert float((rec1 - rec0).abs().max()) > 1e-4


def test_cl_quantized_serving_refresh(monkeypatch):
    """CL on the int8 serving path: the float weights train, the int8 copy is
    quantized again after each step, and scoring keeps working."""
    monkeypatch.setenv("TCVAE_QUANT_MIN_ELEMS", "0")
    multi = _fleet(_model(), cl_ring_ticks=2, quantize=True)
    multi.enable_cont_learning = True
    int8 = {name: p["kernel_i8"].clone() for part in multi._serve_params.values()
            for name, p in part.items() if "kernel_i8" in p}
    assert int8, "nothing was quantized"
    rng = np.random.RandomState(11)
    out = None
    for t in range(3):
        out = multi.process_frames(_frames(rng, 2), now=float(t))
    assert multi.cl_epochs >= 1
    after = {name: p["kernel_i8"] for part in multi._serve_params.values()
             for name, p in part.items() if name in int8}
    assert any(not torch.equal(int8[n], after[n]) for n in int8)
    assert out[0] is not None and out[0].norm_err_u8.shape == (16, 16)


def test_cl_autosave_roundtrip(tmp_path):
    """Fleet-trained weights persist: the cycle saves iff dirty (consuming the
    schedule flag), and the cache loads through the registry with the
    trained parameters and moments."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    cache = str(tmp_path / "cache")
    multi = _fleet(_model(), cl_ring_ticks=2, model_cache_dir=cache, autosave_period_s=1.0)
    multi.enable_cont_learning = True
    rng = np.random.RandomState(12)
    multi.process_frames(_frames(rng, 2), now=0.1)  # seeds the autosave clock
    multi.process_frames(_frames(rng, 2), now=1.0)  # CL steps (dirty), period not elapsed
    assert multi.cl_epochs == 1 and multi.model_changed_flag
    multi.enable_cont_learning = False
    multi.process_frames(_frames(rng, 2), now=1.5)  # the period elapsed: autosave
    assert not multi.model_changed_flag and not multi.schedule_model_save_flag
    loaded, config = load_model_from_directory(cache, device="cpu", restore_optimizer=True)
    assert "cam_info" not in config and loaded.optimizer.count == 1
    for k, v in multi.model.params.items():
        assert torch.equal(loaded.params[k], v), k
    rounds = os.listdir(os.path.join(cache, "rounds"))
    multi.schedule_model_save()  # a clean model: the flag is consumed without a write
    multi.process_frames(_frames(rng, 2), now=1.6)
    assert not multi.schedule_model_save_flag
    assert os.listdir(os.path.join(cache, "rounds")) == rounds


def test_cl_replay_buffer(tmp_path):
    """Fleet CL with a replay buffer: the step equals a step by hand on
    [ring rows ++ replay rows] with the padded replay slot at weight 0; the
    buffer is loaded from the single-stream engine's txt format."""
    rng = np.random.RandomState(13)
    listfile = _write_replay(tmp_path, _frames(rng, 3))
    multi = _fleet(_model(), cl_ring_ticks=2, replay_capacity=4)
    multi.enable_cont_learning = True
    assert multi.load_replay_buffer_from_file(listfile) == 3
    assert multi.replay_buffer.shape == (4, 16, 16, 3)  # capacity-padded
    eps = np.random.RandomState(4).randn(8, 4).astype(np.float32)
    _inject_eps(multi.model, {"eps": eps})
    ticks = [_frames(rng, 2) for _ in range(2)]
    multi.process_frames(ticks[0], now=0.1)
    multi.process_frames(ticks[1], now=1.0)  # steps with the replay rows
    assert multi.cl_epochs == 1

    ring_rows = np.stack(ticks[0] + ticks[1]).astype(np.float32) / 255.0
    stacked = torch.cat([torch.from_numpy(ring_rows), multi.replay_buffer])
    model_b = _model()
    want = _manual_step(model_b, stacked, torch.tensor([1, 1, 1, 1, 1, 1, 1, 0.0]),
                        torch.from_numpy(eps))
    np.testing.assert_allclose(multi.last_epoch_loss["loss"], want["loss"], rtol=1e-5)
    for k, v in model_b.params.items():
        torch.testing.assert_close(multi.model.params[k], v, rtol=1e-4, atol=1e-6)
    # an oversized load grows the capacity in fleet-ring buckets (T x K = 4 rows)
    many = _write_replay(tmp_path, _frames(rng, 5))
    assert multi.load_replay_buffer_from_file(many) == 5 and multi.replay_capacity == 8


def test_recording_per_stream(tmp_path):
    """Each camera gets its own five-stream subtree and labels.json; a
    dropped tick records nothing for that camera; one shared model snapshot
    loads back; each subtree reads as a single-stream recording."""
    sys.path.insert(0, REPO)
    from create_video_from_logs import load_data_from_directory
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    multi = _fleet(_model())
    rec_root = str(tmp_path / "rec")
    os.makedirs(rec_root)
    inst = multi.begin_recording(rec_root, names=["front", "back"])
    multi.record_period_ms = 0.0  # record every tick
    rng = np.random.RandomState(14)
    f = _frames(rng, 3)
    multi.process_frames([f[0], f[1]], now=1.0)
    multi.process_frames([f[2], None], now=2.0)  # back drops this tick
    out = multi.terminate_recording()
    assert out == inst and not multi.recording_flag
    n_front = len(os.listdir(os.path.join(inst, "front", "frames")))
    n_back = len(os.listdir(os.path.join(inst, "back", "frames")))
    assert n_front == 2 and n_back == 1
    for name, n in (("front", n_front), ("back", n_back)):
        for sub in ("err", "heatmap", "overlay", "rec"):
            assert len(os.listdir(os.path.join(inst, name, sub))) == n
        with open(os.path.join(inst, name, "labels.json")) as fh:
            labels = json.load(fh)
        assert len(labels["images"]) == len(labels["annotations"]) == n
    back = sorted(os.listdir(os.path.join(inst, "back", "frames")))
    np.testing.assert_array_equal(np.asarray(Image.open(
        os.path.join(inst, "back", "frames", back[0]))), f[1])
    loaded, _ = load_model_from_directory(os.path.join(inst, "model"), device="cpu")
    for k, v in multi.model.params.items():
        assert torch.equal(loaded.params[k], v), k
    data = load_data_from_directory(os.path.join(inst, "front"))
    assert len(data["frames"]) == n_front


def test_pipelined_recording_pairs_frames_with_their_scores(tmp_path):
    """In pipelined mode the raw batch and the validity mask travel with the
    pending results: a tick's recorded frames are that tick's, with its
    scores, and the flush records the last tick."""
    multi = _fleet(_model(), pipelined=True)
    os.makedirs(tmp_path / "rec")
    inst = multi.begin_recording(str(tmp_path / "rec"))
    multi.record_period_ms = 0.0
    rng = np.random.RandomState(15)
    ticks = [_frames(rng, 2) for _ in range(3)]
    ticks[1][0] = None
    scores = []
    for i, tick in enumerate(ticks):
        out = multi.process_frames(tick, now=float(i))
        scores.append([None if r is None else r.score for r in out])
    last = multi.flush(now=3.0)
    scores.append([None if r is None else r.score for r in last])
    multi.terminate_recording()
    for cam in (0, 1):
        names = sorted(os.listdir(os.path.join(inst, f"cam{cam}", "frames")))
        sent = [t[cam] for t in ticks if t[cam] is not None]
        assert len(names) == len(sent)
        for name, frame in zip(names, sent):
            np.testing.assert_array_equal(
                np.asarray(Image.open(os.path.join(inst, f"cam{cam}", "frames", name))), frame)
        with open(os.path.join(inst, f"cam{cam}", "labels.json")) as fh:
            annotated = [list(a.values())[0] for a in json.load(fh)["annotations"]]
        want = [s[cam] for s in scores[1:] if s[cam] is not None]
        np.testing.assert_array_equal(np.array(annotated, float), np.array(want, float))


def test_all_cameras_cli_end_to_end(tmp_path):
    """The fleet surface from the CLI in one run on the CPU: --all-cameras
    with CL, a replay buffer, recording and a model cache, pipelined."""
    from trustedai_cl_vae_ad_tpu_torch.config import save_config

    model = _model()
    mdir = str(tmp_path / "model")
    model.save_model(mdir, include_optimizer=False)
    save_config(CONFIG, os.path.join(mdir, "config.yml"))
    listfile = _write_replay(tmp_path, _frames(np.random.RandomState(15), 2))
    rec = str(tmp_path / "rec")
    stats = str(tmp_path / "stats.jsonl")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "camera_streamer_torch.py"), "-m", mdir,
         "--device", "cpu", "--all-cameras", "--n-streams", "2", "-c", "--replay-buffer",
         listfile, "--record-dir", rec, "--model-cache-dir", str(tmp_path / "cache"),
         "--max-frames", "6", "--pipelined", "--stats-jsonl", stats, "--warmup"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Replay Buffer Loaded: 2" in proc.stdout
    assert "processed 6 ticks x 2 streams" in proc.stdout
    assert "fleet continual learning:" in proc.stdout and "warming up" in proc.stdout
    rows = [json.loads(line) for line in open(stats)]
    assert sorted(r["tick"] for r in rows) == list(range(6)), rows
    assert rows[-1].get("flushed") and rows[-1]["tick"] == 5
    inst = [d for d in os.listdir(rec) if d.startswith("data_")]
    assert len(inst) == 1
    inst_dir = os.path.join(rec, inst[0])
    assert os.path.isfile(os.path.join(inst_dir, "synthetic0", "labels.json"))
    assert os.path.isdir(os.path.join(inst_dir, "model", "encoder"))
    assert os.path.isfile(os.path.join(inst_dir, "model", "replay_buffer_paths.csv"))
    # the default metrics directory under the model cache got the CL records
    assert os.path.isfile(tmp_path / "cache" / "metrics" / "metrics.jsonl")


def test_recording_duplicate_names(tmp_path):
    multi = _fleet(_model(), n_streams=3)
    rec = str(tmp_path / "rec")
    os.makedirs(rec)
    inst = multi.begin_recording(rec, names=["gate", "gate", "gate"])
    assert multi._stream_names == ["gate", "gate_1", "gate_2"]
    for n in multi._stream_names:
        assert os.path.isdir(os.path.join(inst, n, "frames"))
    with pytest.raises(ValueError, match="2 names for 3 streams"):
        multi.begin_recording(rec, names=["a", "b"])


def test_recording_adversarial_duplicate_names(tmp_path):
    """A renamed candidate is checked again: ['gate', 'gate_1', 'gate']
    gives gate_2, not a second gate_1."""
    multi = _fleet(_model(), n_streams=3)
    rec = str(tmp_path / "rec2")
    os.makedirs(rec)
    inst = multi.begin_recording(rec, names=["gate", "gate_1", "gate"])
    assert multi._stream_names == ["gate", "gate_1", "gate_2"]
    for n in multi._stream_names:
        assert os.path.isdir(os.path.join(inst, n, "frames"))


def test_cl_async_autosave_roundtrip(tmp_path):
    """async_autosave on the fleet engine: the autosave tick writes in the
    background, fleet CL keeps stepping in place, and after drain_autosaves()
    the cache holds the state at the save, bit for bit."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    cache = str(tmp_path / "cache")
    multi = _fleet(_model(), cl_ring_ticks=2, model_cache_dir=cache, autosave_period_s=1.0,
                   async_autosave=True)
    multi.enable_cont_learning = True
    rng = np.random.RandomState(12)
    at_save = []
    save = multi.save_model_to_dir

    def spy(model_dir, saver=None):
        at_save.append({k: v.clone() for k, v in multi.model.params.items()})
        return save(model_dir, saver=saver)

    multi.save_model_to_dir = spy
    multi.process_frames(_frames(rng, 2), now=0.1)  # seeds the autosave clock
    multi.process_frames(_frames(rng, 2), now=1.0)  # CL (dirty)
    multi.process_frames(_frames(rng, 2), now=1.5)  # CL, then the period: an async save
    assert multi._async_saver is not None and not multi.model_changed_flag
    assert len(at_save) == 1
    multi.process_frames(_frames(rng, 2), now=2.0)  # CL on the saved tensors, in place
    multi.drain_autosaves()
    loaded, _ = load_model_from_directory(cache, device="cpu")
    for k, v in at_save[0].items():
        assert torch.equal(loaded.params[k], v), k
    assert any(not torch.equal(multi.model.params[k], v) for k, v in at_save[0].items())


# -- the port's own ---------------------------------------------------------------------------

def test_warmup_cl_prepares_the_step_and_changes_nothing():
    """warmup(cl=True) allocates the ring and the optimizer and runs the
    step's loss and backward once; weights, moments, the generator and the
    ring stay as they were, and no step is counted."""
    multi = _fleet(_model(), cl_ring_ticks=2)
    before = {k: v.clone() for k, v in multi.model.params.items()}
    gen = multi.model.generator.get_state().clone()
    multi.warmup(frame_shape=(20, 24, 3), cl=True)
    assert multi._cl_ring.shape == (2, 2, 16, 16, 3) and multi.model.optimizer.count == 0
    assert float(multi._cl_ring.abs().sum()) == 0.0 and multi._cl_valid.sum() == 0
    assert all(torch.equal(before[k], v) for k, v in multi.model.params.items())
    assert torch.equal(multi.model.generator.get_state(), gen) and multi.cl_epochs == 0
    assert multi._ref_shape == (20, 24, 3) and multi._warm_pin


def test_int8_boot_refuses_fleet_cl(tmp_path, monkeypatch):
    """An int8-checkpoint boot holds no float parameters: the CL controls
    raise, scoring works."""
    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    monkeypatch.setenv("TCVAE_QUANT_MIN_ELEMS", "0")
    model = _model()
    d = str(tmp_path / "m")
    model.save_model(d, include_optimizer=False)
    save_config(CONFIG, os.path.join(d, "config.yml"))
    quant.save_quantized_checkpoint(d, quant.quantize_params(model.core, model.params))
    booted, cfg = quant.load_int8_serving_model(d, device="cpu", log=lambda m: None)
    multi = MultiCameraEngine(booted, cfg, n_streams=2, qparams=booted.qparams)
    with pytest.raises(RuntimeError, match="int8 checkpoint"):
        multi.set_learning_rate(1e-3)
    multi.enable_cont_learning = True
    with pytest.raises(RuntimeError, match="int8 checkpoint"):
        multi.process_frames(_frames(np.random.RandomState(0), 2), now=1.0)
    multi.enable_cont_learning = False
    out = multi.process_frames(_frames(np.random.RandomState(0), 2), now=2.0)
    assert all(np.isfinite(r.pixel_count) for r in out)
