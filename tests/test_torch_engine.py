"""The port's StreamingEngine vs the JAX StreamingEngine: same weights, same
frames; the CLI; the options that are not ported yet."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import tiny_config, to_np, torch_model_like
from trustedai_cl_vae_ad_tpu_torch.testing import warm_score_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIXED = {
    "anomaly_score_threshold": 2.0,
    "anomaly_score_method": "zz_count",
    "buffer_record_period_s": 1.0,
    "anomalous_state_period_s": 0.05,
}
CDF = dict(FIXED, anomaly_score_method="cdf", cdf_warmup_abstain=False)


def _frames(n=12):
    """40x64 synthetic frames (the engines resize them to 32x48), a static
    scene with sensor noise and a bright blob in frames 8 and 9."""
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource

    src = SyntheticSource(width=64, height=40, n_frames=n, anomaly_frames=range(8, 10),
                          motion=0.0, seed=5)
    return list(src)


@pytest.fixture(scope="module")
def models():
    from trustedai_cl_vae_ad_tpu.registry import load_model_from_config as jax_load

    config = tiny_config(image=(32, 48, 3))
    jmodel = jax_load(config)
    tmodel = torch_model_like(config, jmodel.params)
    return config, jmodel, tmodel


def _engines(models, settings, pipelined, warm=True):
    from trustedai_cl_vae_ad_tpu.ops.stream_score import StreamScoreState as JState
    from trustedai_cl_vae_ad_tpu.stream.engine import StreamingEngine as JaxEngine
    from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState as TState
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    config, jmodel, tmodel = models
    j = JaxEngine(jmodel, config, anomaly_settings=settings, pipelined=pipelined)
    t = StreamingEngine(tmodel, config, anomaly_settings=settings, pipelined=pipelined)
    for e in (j, t):
        e.inference_period_ms = 0.0
    if warm:
        maps, scalars = warm_score_state(32, 48)
        j.score_state = JState(jnp.asarray(maps), jnp.asarray(scalars))
        t.score_state = TState(torch.from_numpy(maps), torch.from_numpy(scalars))
    return j, t


def _run(engine, frames):
    out = []
    for i, f in enumerate(frames):
        r = engine.process_frame(f, now=float(i), tag=i)
        if r is not None:
            out.append(r)
    last = engine.flush(now=float(len(frames)))
    if last is not None:
        out.append(last)
    return out


@pytest.mark.parametrize("settings", [FIXED, CDF], ids=["fixed", "cdf"])
@pytest.mark.parametrize("pipelined", [False, True], ids=["plain", "pipelined"])
def test_engine_matches_jax_engine(models, settings, pipelined):
    frames = _frames()
    j, t = _engines(models, settings, pipelined)
    jr, tr = _run(j, frames), _run(t, frames)
    assert len(jr) == len(tr) == len(frames)
    counts_agreed = True
    for a, b in zip(jr, tr):
        assert a.tag == b.tag
        assert abs(a.pixel_count - b.pixel_count) <= 2, (a.tag, a.pixel_count, b.pixel_count)
        counts_agreed = counts_agreed and a.pixel_count == b.pixel_count
        if counts_agreed:
            assert abs(a.score - b.score) <= 1e-3, (a.tag, a.score, b.score)
            assert abs(a.score_ma - b.score_ma) <= 1e-3, (a.tag, a.score_ma, b.score_ma)
            assert a.anomalous == b.anomalous, a.tag
        assert np.max(np.abs(a.norm_err_u8.astype(int) - b.norm_err_u8.astype(int))) <= 1
        assert np.max(np.abs(a.reconstruction_u8.astype(int)
                             - b.reconstruction_u8.astype(int))) <= 1
    assert counts_agreed  # otherwise the score checks above were skipped
    assert any(r.anomalous for r in tr)  # the blob is well above threshold
    np.testing.assert_allclose(to_np(t.ring), np.asarray(j.ring), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(t.score_state.maps), np.asarray(j.score_state.maps),
                               rtol=1e-5, atol=1e-6)


def test_fresh_engine_seeds_ring_and_matches_maps(models):
    """From a fresh state: the first frame seeds every ring slot, and the
    reconstruction and normalized-error images match the JAX engine."""
    frames = _frames(4)
    j, t = _engines(models, FIXED, pipelined=False, warm=False)
    t.process_frame(frames[0], now=0.0)
    ring = to_np(t.ring)
    assert all(np.array_equal(ring[0], ring[k]) for k in range(1, t.RING_SIZE))
    t = _engines(models, FIXED, pipelined=False, warm=False)[1]
    for a, b in zip(_run(j, frames), _run(t, frames)):
        assert np.max(np.abs(a.norm_err_u8.astype(int) - b.norm_err_u8.astype(int))) <= 1
        assert np.max(np.abs(a.reconstruction_u8.astype(int)
                             - b.reconstruction_u8.astype(int))) <= 1


def test_cdf_threshold_matches_jax(models):
    from trustedai_cl_vae_ad_tpu.stream.engine import StreamingEngine as JaxEngine
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    config, jmodel, tmodel = models
    settings = dict(CDF, cdf_warmup_skip=3, cdf_window=64)
    j = JaxEngine(jmodel, config, anomaly_settings=settings)
    t = StreamingEngine(tmodel, config, anomaly_settings=settings)
    scores = np.random.RandomState(0).standard_t(3, 120)
    for k, s in enumerate(scores):
        for e in (j, t):
            e._record_score(float(s) if k % 17 else float("nan"))
        if k % 10 == 9:
            assert t.current_threshold() == pytest.approx(j.current_threshold(), rel=1e-12)
    for e in (j, t):
        e.new_task()
    assert t.current_threshold() == j.current_threshold() == 2.0  # warm-up fallback


def test_hold_off_and_state_machine(models):
    config, _, tmodel = models
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    t = StreamingEngine(tmodel, config, anomaly_settings=FIXED, inference_period_ms=50.0)
    frame = _frames(1)[0]
    assert t.process_frame(frame, now=1.0) is not None
    assert t.process_frame(frame, now=1.01) is None  # inside the 50 ms hold-off
    assert set(t.timings) == {"infer_s", "cl_s", "record_s", "total_s"}
    t.toggle_anomalous_state(False, now=1.5)
    t.anomaly_score = 5.0
    t.check_anomalous_state(now=2.0)
    assert t.anomalous_state
    t.anomaly_score = 0.0
    t.check_anomalous_state(now=2.01)
    assert t.anomalous_state  # held
    t.check_anomalous_state(now=2.1)
    assert not t.anomalous_state


def test_unported_options_raise(models):
    """What stays unported raises and names its ROADMAP item: int8 serving,
    autosave, recording."""
    from trustedai_cl_vae_ad_tpu_torch.ops.quant import serving_forward
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    config, _, tmodel = models
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        StreamingEngine(tmodel, config, quantize=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        serving_forward(tmodel.core, tmodel.params, quantize=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        StreamingEngine(tmodel, config, model_cache_dir="model_cache")
    t = StreamingEngine(tmodel, config)
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        t.begin_recording("rec")
    assert not hasattr(t, "terminate_recording") and not hasattr(t, "save_model_to_dir")
    t.warmup(frame_shape=(40, 64, 3))  # the scratch run leaves the state untouched
    assert t.ring_filled == 0 and float(t.score_state.scalars.abs().sum()) == 0.0


def test_cl_controls_exist_and_default_off(models):
    """The controls that used to raise: continual learning is a plain
    attribute, off by default, and an engine that never uses it allocates no
    optimizer."""
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    config, _, tmodel = models
    assert tmodel.optimizer is None
    t = StreamingEngine(tmodel, config, cam_info={"name": "cam"}, replay_capacity=32,
                        continuous_learning_period_ms=250.0)
    assert t.enable_cont_learning is False and t.cl_epochs == 0 and t.last_epoch_loss is None
    assert t.model_changed_flag is False and t.cam_info == {"name": "cam"}
    assert t.replay_capacity == 32 and t.replay_buffer is None and t.replay_n == 0
    assert t.continuous_learning_period_ms == 250.0
    t.enable_cont_learning = True
    t.enable_cont_learning = False
    t.inference_period_ms = 0.0
    r = t.process_frame(_frames(1)[0], now=10.0)
    assert r.cl_stepped is False and r.loss is None and t.timings["cl_s"] >= 0.0
    assert t.load_replay_buffer_from_filelist(["no_such.png"]) == 0 and t.replay_buffer is None
    assert tmodel.optimizer is None


def test_camera_streamer_torch_cli(tmp_path):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(
        "data:\n  image_size: [32, 48, 3]\n"
        "loss: {kurtosis: 1.8, w_kl_divergence: 0.0, w_kurtosis: 1.0e-4, w_mse: 1.0,"
        " w_skew: 0.0, w_z_l1_reg: 0.0}\n"
        "model:\n  type: KurtosisGlobal\n  latent_dimensions: 8\n  layers: [4, 8]\n"
        "  decoder_dense_filters: 4\n"
        "training: {batch_size: 8, beta: 1.0e-6, learning_rate: 1.0e-3, max_epochs: 1}\n")
    stats = tmp_path / "stats.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "camera_streamer_torch.py"),
         os.path.join(REPO, "configs", "cam_config.yml"), "--device", "cpu",
         "--config", str(cfg), "--source", "synthetic", "--max-frames", "3",
         "--stats-jsonl", str(stats), "--warmup", "240x320"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in stats.read_text().splitlines()]
    assert [r["frame"] for r in rows] == [0, 1, 2]
    assert all(set(r) >= {"score", "score_ma", "count", "anomalous", "latency_ms"} for r in rows)
    assert "latency p50=" in proc.stdout
    assert "jax" not in proc.stderr.lower()
