"""Continual learning in the port's StreamingEngine against the JAX engine:
the same weights (through the bridge), frames, injected clock and latent
noise give the same CL cadence, loss dicts and post-step parameters, with and
without a replay buffer; the replay loader against the JAX loader; lazy
optimizer allocation; ``warmup(cl=True)``; the CLI's continual-learning flags.

Tolerances: CL loss dicts at rtol 1e-4 / atol 1e-6 (sums and convolutions in
another order); parameters after the steps as tests/test_torch_train_step.py
holds them (Adam turns a rounding-noise gradient into a full step, so a few
entries may differ by up to lr per step); replay buffers at atol 1e-5 (the
antialias resize, as tests/test_torch_resize.py)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_helpers import (
    LOSS_KEYS_BY_TYPE,
    next_jax_eps,
    paired_models,
    to_np,
    typed_config,
)
from trustedai_cl_vae_ad_tpu_torch.bridge import params_to_flax
from trustedai_cl_vae_ad_tpu_torch.testing import warm_score_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPACITY = 16


def _frames(n=8):
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource

    return list(SyntheticSource(width=64, height=40, n_frames=n, motion=0.0, seed=5))


def _write_images(directory, n, seed=0):
    """n PNGs, alternately at camera size (40x64, resized on load) and at
    model size (32x48); returns their paths."""
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        shape = (40, 64, 3) if i % 2 == 0 else (32, 48, 3)
        path = os.path.join(str(directory), f"img_{seed}_{i}.png")
        Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8)).save(path)
        paths.append(path)
    return paths


def _engines(config, seed=1, **kwargs):
    from trustedai_cl_vae_ad_tpu.ops.stream_score import StreamScoreState as JState
    from trustedai_cl_vae_ad_tpu.stream.engine import StreamingEngine as JaxEngine
    from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState as TState
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    jmodel, tmodel = paired_models(config, seed=seed, compile=False)
    j = JaxEngine(jmodel, config, **kwargs)
    t = StreamingEngine(tmodel, config, **kwargs)
    maps, scalars = warm_score_state(32, 48)
    j.score_state = JState(jnp.asarray(maps), jnp.asarray(scalars))
    t.score_state = TState(torch.from_numpy(maps), torch.from_numpy(scalars))
    for e in (j, t):
        e.inference_period_ms = 0.0
    return j, t


def _inject_eps(tmodel, box):
    """Make the port's CL step take the latent noise in ``box['eps']``."""
    step = tmodel.train_step_and_run

    def with_eps(x, eps=None, weights=None):
        return step(x, eps=torch.from_numpy(box["eps"]), weights=weights)

    tmodel.train_step_and_run = with_eps


def _leaves(tree):
    for part in ("encoder", "decoder"):
        for layer, leaves in tree[part].items():
            for leaf, arr in leaves.items():
                yield f"{part}/{layer}/{leaf}", np.asarray(arr)


CASES = [("KurtosisGlobal", False), ("KurtosisGlobal", True), ("KurtosisSingle", True),
         ("KLGaussian", False)]


@pytest.mark.parametrize("model_type, replay", CASES,
                         ids=[f"{t}-{'replay' if r else 'ring'}" for t, r in CASES])
def test_cl_matches_jax_engine(model_type, replay, tmp_path):
    config = typed_config(model_type)
    j, t = _engines(config, continuous_learning_period_ms=500.0, replay_capacity=CAPACITY)
    if replay:
        paths = _write_images(tmp_path, 5)
        assert j.load_replay_buffer_from_filelist(paths) == 5
        assert t.load_replay_buffer_from_filelist(paths) == 5
    rows = t.RING_SIZE + (CAPACITY if replay else 0)
    box = {}
    _inject_eps(t.model, box)
    for e in (j, t):
        e.enable_cont_learning = True
    assert t.model.optimizer is None  # nothing is allocated before the first step
    stepped = []
    for i, frame in enumerate(_frames(8)):
        box["eps"] = next_jax_eps(j.model, rows)  # what a JAX CL step would draw now
        a = j.process_frame(frame, now=0.3 * i, tag=i)
        b = t.process_frame(frame, now=0.3 * i, tag=i)
        assert a.cl_stepped == b.cl_stepped, i
        assert abs(a.pixel_count - b.pixel_count) <= 2, (i, a.pixel_count, b.pixel_count)
        assert np.max(np.abs(a.reconstruction_u8.astype(int)
                             - b.reconstruction_u8.astype(int))) <= 1
        if not b.cl_stepped:
            assert b.loss is None and t.timings["cl_s"] < 0.01
            continue
        stepped.append(i)
        keys = LOSS_KEYS_BY_TYPE[model_type] + ["anomaly_score", "anomaly_score_ma"]
        assert set(b.loss) == set(a.loss) == set(keys) and list(b.loss) == keys
        for k in LOSS_KEYS_BY_TYPE[model_type]:
            np.testing.assert_allclose(b.loss[k], a.loss[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"frame {i} {k}")
        # the CL record carries the scores booked before this frame's
        np.testing.assert_allclose(b.loss["anomaly_score_ma"], a.loss["anomaly_score_ma"],
                                   atol=1e-3)
        assert b.loss == t.last_epoch_loss and t.timings["cl_s"] > 0.0
    assert stepped == [2, 4, 6] and t.cl_epochs == j.cl_epochs == 3
    assert t.model_changed_flag and t.model.optimizer.count == 3
    lr = config["training"]["learning_rate"]
    after_j = dict(_leaves(jax.device_get(j.model.params)))
    after_t = dict(_leaves(params_to_flax(t.model.params)))
    for name, ref in after_j.items():
        np.testing.assert_allclose(after_t[name], ref, rtol=0, atol=0.05 * 3 * lr, err_msg=name)
        assert (np.abs(after_t[name] - ref) <= 1e-5).mean() > 0.99, name
    np.testing.assert_allclose(to_np(t.ring), np.asarray(j.ring), rtol=1e-5, atol=1e-6)


def test_frames_after_a_cl_step_are_scored_with_the_new_weights():
    config = typed_config("KurtosisGlobal")
    _j, t = _engines(config, continuous_learning_period_ms=0.0)
    frames = _frames(3)
    first = t.process_frame(frames[0], now=1.0)
    assert not first.cl_stepped  # continual learning is off by default
    with torch.inference_mode():
        before = t._forward(t._serve_params, t.ring[:1]).clone()
    t.enable_cont_learning = True
    assert t.process_frame(frames[1], now=2.0).cl_stepped
    with torch.inference_mode():
        after = t._forward(t._serve_params, t.ring[:1])
    assert float((after - before).abs().max()) > 1e-5


def test_replay_loader_equals_the_jax_loader(tmp_path, capsys):
    from trustedai_cl_vae_ad_tpu.stream import engine as jengine
    from trustedai_cl_vae_ad_tpu_torch.stream import engine as tengine

    paths = _write_images(tmp_path, 5)
    broken = tmp_path / "broken.png"
    broken.write_text("not an image")
    listed = paths[:3] + [str(broken), str(tmp_path / "missing.png")] + paths[3:]
    txt = tmp_path / "replay.txt"
    txt.write_text("\n".join(listed) + "\n\n")
    csv_file = tmp_path / "replay.csv"
    csv_file.write_text("".join(f"{p},extra\n" for p in listed))
    # missing paths are dropped when the file is parsed, as the JAX parser does
    for name in (txt, csv_file):
        assert tengine.parse_replay_file(str(name)) == jengine.parse_replay_file(str(name))
        assert len(tengine.parse_replay_file(str(name))) == 6
    with pytest.raises(ValueError, match="extension"):
        tengine.parse_replay_file(str(broken))
    with pytest.raises(FileNotFoundError):
        tengine.parse_replay_file(str(tmp_path / "nothing.txt"))

    config = typed_config("KurtosisGlobal")
    j, t = _engines(config, replay_capacity=CAPACITY)
    for name in (txt, csv_file):
        assert j.load_replay_buffer_from_file(str(name)) == 5  # the broken file is skipped
        assert t.load_replay_buffer_from_file(str(name)) == 5
        assert t.replay_n == j.replay_n == 5 and t.replay_capacity == CAPACITY
        assert t.replay_buffer_paths == j.replay_buffer_paths == [os.path.abspath(p)
                                                                  for p in paths]
        assert t.replay_buffer.shape == j.replay_buffer.shape == (CAPACITY, 32, 48, 3)
        np.testing.assert_allclose(to_np(t.replay_buffer), np.asarray(j.replay_buffer),
                                   rtol=0, atol=1e-5)
        assert float(t.replay_buffer[5:].abs().max()) == 0.0  # the padding
    assert "Replay Buffer Loaded: 5 images (capacity 16)" in capsys.readouterr().out
    # a load above the capacity grows it in buckets of RING_SIZE
    more = paths + _write_images(tmp_path, 16, seed=1)
    assert t.load_replay_buffer_from_filelist(more) == j.load_replay_buffer_from_filelist(more)
    assert t.replay_n == 21 and t.replay_capacity == j.replay_capacity == 32
    assert t.replay_buffer.shape[0] == 32
    np.testing.assert_allclose(to_np(t.replay_buffer), np.asarray(j.replay_buffer),
                               rtol=0, atol=1e-5)
    stacked, weights = t._cl_batch()
    assert stacked.shape[0] == 48 and weights.tolist() == [1.0] * 37 + [0.0] * 11


def test_decode_chain_matches_the_jax_package(tmp_path):
    from trustedai_cl_vae_ad_tpu.data import pipeline as jpipeline
    from trustedai_cl_vae_ad_tpu_torch.data import pipeline as tpipeline

    paths = _write_images(tmp_path, 4)
    jpg = str(tmp_path / "photo.jpg")
    Image.fromarray(np.random.RandomState(3).randint(0, 256, (20, 30, 3), dtype=np.uint8)).save(jpg)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG nothing")
    listed = paths[:2] + [str(bad), jpg] + paths[2:]
    got = list(tpipeline.ParallelDecodeIterable(listed, num_workers=2, prefetch=2))
    ref = list(jpipeline.ParallelDecodeIterable(listed, num_workers=2, prefetch=2))
    assert [p for _, p in got] == [p for _, p in ref] == paths[:2] + [jpg] + paths[2:]
    for (a, _), (b, _) in zip(got, ref):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert tpipeline.decode_image_rgb(str(bad)) is None
    assert len(tpipeline.ParallelDecodeIterable(listed)) == len(listed) == 6


def test_optimizer_is_allocated_at_the_first_cl_control():
    """An inference-only engine never holds Adam's moments; the first CL
    step or the learning-rate dial allocates them (the JAX engine's
    tests/test_stream.py::test_engine_optimizer_is_lazy)."""
    config = typed_config("KurtosisGlobal")
    _j, t = _engines(config, continuous_learning_period_ms=0.0)
    frames = _frames(3)
    t.process_frame(frames[0], now=1.0)
    t.set_img_noise(0.25)  # stored, allocates nothing
    assert t.model.beta == 0.25 and t.model.optimizer is None
    t.enable_cont_learning = True
    assert t.model.optimizer is None
    assert t.process_frame(frames[1], now=2.0).cl_stepped
    assert t.model.optimizer is not None and t.model.optimizer.count == 1

    _j, t = _engines(config)
    t.set_learning_rate(2.5e-4)
    assert t.model.optimizer is not None and t.model.learning_rate == 2.5e-4
    assert t.model.optimizer.count == 0


def test_img_noise_has_no_effect_on_the_cl_step():
    config = typed_config("KurtosisGlobal")
    losses = []
    for beta in (None, 0.5):
        _j, t = _engines(config, continuous_learning_period_ms=0.0)
        _inject_eps(t.model, {"eps": np.zeros((16, 8), np.float32)})
        if beta is not None:
            t.set_img_noise(beta)
        t.enable_cont_learning = True
        losses.append(t.process_frame(_frames(1)[0], now=1.0).loss)
    assert losses[0] == losses[1]


@pytest.mark.parametrize("replay", [False, True], ids=["ring", "replay"])
def test_warmup_cl_leaves_every_state_untouched(replay, tmp_path):
    config = typed_config("KurtosisSingle")
    _j, t = _engines(config, replay_capacity=CAPACITY)
    if replay:
        t.load_replay_buffer_from_filelist(_write_images(tmp_path, 3))
    t.process_frame(_frames(1)[0], now=1.0)
    params = {k: v.clone() for k, v in t.model.params.items()}
    ring, maps, scalars = t.ring.clone(), t.score_state.maps.clone(), t.score_state.scalars.clone()
    generator = t.model.generator.get_state().clone()
    seen = []
    compute_loss = t.model.core.compute_loss
    t.model.core.compute_loss = lambda x, **kw: (seen.append(tuple(x.shape)),
                                                 compute_loss(x, **kw))[1]
    t.warmup(frame_shape=(40, 64, 3), cl=True)
    t.model.core.compute_loss = compute_loss
    # the scratch batch has the CL step's shape: ring, or ring + padded replay
    assert seen == [(16 + (CAPACITY if replay else 0), 32, 48, 3)]
    opt = t.model.optimizer
    assert opt is not None and opt.count == 0  # allocated, not stepped
    assert all(float(m.abs().max()) == 0.0 for m in opt.mu + opt.nu)
    for k, v in t.model.params.items():
        assert torch.equal(v, params[k]), k
    assert all(p.grad is None for p in t.model.core.parameters())
    assert torch.equal(t.ring, ring) and t.ring_filled == 1 and t.cl_epochs == 0
    assert torch.equal(t.score_state.maps, maps) and torch.equal(t.score_state.scalars, scalars)
    assert torch.equal(t.model.generator.get_state(), generator)
    assert not t.model_changed_flag


def test_cl_metrics_are_logged_per_epoch(tmp_path):
    from trustedai_cl_vae_ad_tpu_torch.utils.metrics import MetricsWriter

    config = typed_config("KLGaussian")
    with MetricsWriter(str(tmp_path), use_tensorboard=False) as writer:
        _j, t = _engines(config, continuous_learning_period_ms=0.0, metrics=writer)
        t.enable_cont_learning = True
        for i, frame in enumerate(_frames(3)):
            t.process_frame(frame, now=1.0 + i)
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    expected = {f"cl/{k}" for k in LOSS_KEYS_BY_TYPE["KLGaussian"]}
    expected |= {"cl/anomaly_score", "cl/anomaly_score_ma", "step", "time"}
    assert all(set(r) == expected for r in records)
    assert records[-1]["cl/loss"] == t.last_epoch_loss["loss"]


def _saved_model(tmp_path, steps=2):
    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.testing import train_inputs

    config = typed_config("KurtosisSingle")
    model = load_model_from_config(config, seed=4, device="cpu")
    model.compile()
    for x, _ in train_inputs(config, n_steps=steps, batch=8):
        model.train_step(x)
    logdir = str(tmp_path / "fit")
    model.save_model(logdir)
    save_config(config, os.path.join(logdir, "config.yml"))
    return logdir


def test_cli_continual_learning_flags(tmp_path, monkeypatch, capsys):
    """``-m`` with ``-c`` restores the optimizer state; the learning rate,
    the img noise, the replay file, the model directory's own
    ``replay_buffer_paths.csv`` and ``--metrics-dir`` reach the engine; the
    warm-up prepares the CL step; without ``-c`` a learning rate is ignored
    and no optimizer is allocated."""
    import camera_streamer_torch as cli

    logdir = _saved_model(tmp_path)
    images = _write_images(tmp_path, 4)
    with open(os.path.join(logdir, "replay_buffer_paths.csv"), "w") as f:
        f.write("".join(f"{p}\n" for p in images[:3]))
    captured = []
    monkeypatch.setattr(cli, "run_stream", lambda engine, source, **kw: captured.append(
        (engine, kw)))
    base = ["-m", logdir, "--device", "cpu", "--source", "synthetic", "--max-frames", "2"]

    cli.main(base + ["--learning-rate", "1e-5"])
    engine, _ = captured[-1]
    assert "--learning-rate ignored without --continual-learning" in capsys.readouterr().out
    assert engine.enable_cont_learning is False and engine.model.optimizer is None
    assert engine.replay_n == 3  # the model directory's own replay list

    replay = tmp_path / "replay.txt"
    replay.write_text("\n".join(images))
    metrics_dir = tmp_path / "cl_metrics"
    cli.main(base + ["-c", "--learning-rate", "1e-5", "--img-noise", "0.125", "--replay-buffer",
                     str(replay), "--metrics-dir", str(metrics_dir), "--warmup"])
    engine, kwargs = captured[-1]
    out = capsys.readouterr().out
    assert "CL step" in out and "ignored" not in out
    assert engine.enable_cont_learning is True
    assert engine.model.optimizer.count == 2  # restored with the weights
    assert float(max(m.abs().max() for m in engine.model.optimizer.nu)) > 0.0
    assert engine.model.learning_rate == 1e-5 and engine.model.beta == 0.125
    assert engine.replay_n == 4  # the explicit file replaced the recorded list
    assert engine.metrics is not None and os.path.isfile(metrics_dir / "metrics.jsonl")
    assert engine.inference_period_ms == 0.0 and kwargs["max_frames"] == 2
    assert engine.cl_epochs == 0  # the warm-up stepped nothing


def test_cli_continual_learning_end_to_end(tmp_path):
    """The CLI as a process on the CPU: a CL step runs in the first frame
    (the CL clock starts at 0), its metrics land in --metrics-dir."""
    import subprocess
    import sys

    logdir = _saved_model(tmp_path, steps=1)
    stats = tmp_path / "stats.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "camera_streamer_torch.py"), "-m", logdir,
         "--device", "cpu", "--source", "synthetic", "--max-frames", "3", "-c",
         "--metrics-dir", str(tmp_path / "m"), "--stats-jsonl", str(stats)],
        capture_output=True, text=True, timeout=180, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in stats.read_text().splitlines()]
    assert rows[0]["cl_stepped"] is True and len(rows) == 3
    assert "continual learning:" in proc.stdout
    records = [json.loads(line) for line in (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    assert records and "cl/z_l2" in records[0]
