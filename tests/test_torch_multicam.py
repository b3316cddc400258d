"""The port's MultiCameraEngine: against the JAX MultiCameraEngine on the same
weights and frames, against K independent single-stream engines of the port,
and the port's counterparts of tests/test_multicam.py's inference cases; the
multi-camera run loop and CLI on the CPU."""

import json
import os
import re
import subprocess
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_helpers import tiny_config, to_np, torch_model_like
from trustedai_cl_vae_ad_tpu_torch.ops import quant, stream_score
from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine
from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine, StreamStatus
from trustedai_cl_vae_ad_tpu_torch.stream.run import PacedReader, run_all_cameras
from trustedai_cl_vae_ad_tpu_torch.testing import COUNT_TOL, warm_score_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = {"anomaly_score_threshold": 2.0, "anomaly_score_method": "zz_count",
            "buffer_record_period_s": 1.0, "anomalous_state_period_s": 0.05}


@pytest.fixture(scope="module")
def setup():
    """(JAX model, the port's model with the same weights, config)."""
    from trustedai_cl_vae_ad_tpu.registry import load_model_from_config as jax_load

    config = tiny_config(image=(16, 16, 3), layers=(4,), latent=4, ddf=4,
                         model_type="KurtosisSingle")
    jmodel = jax_load(config)
    return jmodel, torch_model_like(config, jmodel.params), config


def _frame(rng, shape=(16, 16, 3)):
    return rng.randint(0, 255, shape, np.uint8)


def _warm(engine, k):
    maps, scalars = warm_score_state(engine.height, engine.width)
    engine.maps = torch.from_numpy(np.stack([maps] * k))
    engine.scalars = torch.from_numpy(np.stack([scalars] * k))


def _scene_ticks(k, n, shape=(20, 24, 3), seed=7, blob_tick=None):
    """n ticks of k static scenes with sensor noise (and a bright blob on one
    tick), uint8."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (k, *shape)).astype(np.int16)
    ticks = []
    for t in range(n):
        tick = np.clip(base + rng.randint(-3, 4, base.shape), 0, 255).astype(np.uint8)
        if t == blob_tick:
            tick[:, 8:12, 10:14, :] = 255
        ticks.append(list(tick))
    return ticks


# -- against the JAX engine ------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True], ids=["plain", "pipelined"])
def test_matches_jax_multicam_engine(setup, pipelined):
    """The same weights, the same 20x24 frames (both engines resize them to
    16x16 on the device) and one stream dropping a tick, from a shared warm
    scorer state (a fresh state's first count is rounding noise): counts
    within 2, and scores, moving averages and alarms equal up to the first
    tick whose counts differ, as testing.py holds single sequences."""
    from trustedai_cl_vae_ad_tpu.stream.multicam import MultiCameraEngine as JaxMulti

    jmodel, tmodel, config = setup
    k = 3
    ticks = _scene_ticks(k, 10, blob_tick=7)
    ticks[3][1] = None
    j = JaxMulti(jmodel, config, n_streams=k, anomaly_settings=dict(SETTINGS),
                 pipelined=pipelined)
    t = MultiCameraEngine(tmodel, config, n_streams=k, anomaly_settings=dict(SETTINGS),
                          pipelined=pipelined)
    maps, scalars = warm_score_state(16, 16)
    j.maps, j.scalars = jnp.asarray(np.stack([maps] * k)), jnp.asarray(np.stack([scalars] * k))
    _warm(t, k)

    def run(engine):
        outs = [engine.process_frames(tick, now=float(i), tag=i) for i, tick in enumerate(ticks)]
        last = engine.flush(now=float(len(ticks)))
        return outs + ([last] if last is not None else [])

    jr, tr = run(j), run(t)
    assert len(jr) == len(tr) == len(ticks) + int(pipelined)
    agreed = [True] * k
    compared = 0
    for jo, to in zip(jr, tr):
        for i in range(k):
            a, b = jo[i], to[i]
            assert (a is None) == (b is None)
            if a is None:
                continue
            assert abs(a.pixel_count - b.pixel_count) <= COUNT_TOL
            agreed[i] = agreed[i] and a.pixel_count == b.pixel_count
            if agreed[i]:
                compared += 1
                assert np.isnan(a.score) == np.isnan(b.score)
                if not np.isnan(a.score):
                    assert abs(a.score - b.score) <= 1e-3, (i, a.score, b.score)
                assert abs(a.score_ma - b.score_ma) <= 1e-3
                assert a.anomalous == b.anomalous
            assert int(np.abs(a.norm_err_u8.astype(int) - b.norm_err_u8.astype(int)).max()) <= 1
            assert int(np.abs(a.reconstruction_u8.astype(int)
                              - b.reconstruction_u8.astype(int)).max()) <= 1
    assert all(agreed) and compared == k * len(ticks) - 1
    assert any(r.anomalous for out in tr for r in out if r is not None)  # the blob
    np.testing.assert_allclose(to_np(t.maps), np.asarray(j.maps), rtol=1e-5, atol=1e-6)
    assert j.last_emitted_tag == t.last_emitted_tag == len(ticks) - 1


def test_batched_scorer_matches_jax_vmapped_reference():
    """stream_score_step_batched on the CPU (a loop over the plain version,
    then the validity mask) against the JAX engine's vmapped scorer_one."""
    import jax

    from trustedai_cl_vae_ad_tpu.ops import stream_score as jss

    rng = np.random.RandomState(0)
    k, h, w, c = 4, 9, 11, 3
    maps, scalars = warm_score_state(h, w)
    maps = np.stack([maps] * k) * rng.uniform(0.8, 1.2, (k, 1, 1, 1)).astype(np.float32)
    scalars = np.stack([scalars] * k)
    img = rng.uniform(0, 1, (k, h, w, c)).astype(np.float32)
    rec = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
    valid = np.array([True, False, True, True])

    def scorer_one(m, s, x, y, ok):
        state, norm, score, count = jss.stream_score_step_reference(
            jss.StreamScoreState(m, s), x, y, 0.99)
        return (jnp.where(ok, state.maps, m), jnp.where(ok, state.scalars, s), norm,
                jnp.where(ok, score, jnp.nan), jnp.where(ok, count, 0.0))

    want = jax.vmap(scorer_one)(*(jnp.asarray(a) for a in (maps, scalars, img, rec, valid)))
    before = stream_score.launches
    got = stream_score.stream_score_step_batched(
        *(torch.from_numpy(a) for a in (maps, scalars, img, rec)), 0.99, torch.from_numpy(valid))
    assert stream_score.launches == before  # the plain version does not count
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3][:, 0].numpy(), np.asarray(want[3]), rtol=1e-4)
    np.testing.assert_array_equal(got[3][:, 1].numpy(), np.asarray(want[4]))
    assert np.isnan(float(got[3][1, 0])) and float(got[3][1, 1]) == 0.0
    np.testing.assert_array_equal(got[0][1].numpy(), maps[1])
    np.testing.assert_array_equal(got[1][1].numpy(), scalars[1])
    with pytest.raises(ValueError):
        stream_score.stream_score_step_batched(
            *(torch.from_numpy(a[0]) for a in (maps, scalars, img, rec)), 0.99,
            torch.from_numpy(valid))


# -- the port's counterparts of tests/test_multicam.py ------------------------------------

def test_matches_independent_engines(setup):
    """K batched streams score as K separate single-stream engines of the
    port fed the same frames. On the CPU both run the same plain scorer, so
    the scores agree to rounding of the batched forward."""
    _, model, config = setup
    settings = dict(SETTINGS, anomalous_state_period_s=1e9)
    k, n = 3, 25
    rngs = [np.random.RandomState(10 + i) for i in range(k)]
    frames = [[_frame(r, (20, 24, 3)) for _ in range(n)] for r in rngs]
    singles = [StreamingEngine(model, config, anomaly_settings=dict(settings),
                               inference_period_ms=0.0) for _ in range(k)]
    multi = MultiCameraEngine(model, config, n_streams=k, anomaly_settings=dict(settings))
    for t in range(n):
        out = multi.process_frames([frames[i][t] for i in range(k)], now=float(t))
        for i in range(k):
            s, m = singles[i].process_frame(frames[i][t], now=float(t)), out[i]
            if np.isnan(s.score):
                assert np.isnan(m.score), (t, i)
            else:
                np.testing.assert_allclose(m.score, s.score, rtol=1e-4, atol=1e-5)
                np.testing.assert_allclose(m.pixel_count, s.pixel_count, atol=0.5)
            diff = np.abs(m.norm_err_u8.astype(int) - s.norm_err_u8.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (t, i)
            assert m.anomalous == s.anomalous, (t, i)


def test_dropped_frames_freeze_state(setup):
    _, model, config = setup
    multi = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=SETTINGS)
    rng = np.random.RandomState(0)
    for _ in range(5):
        multi.process_frames([_frame(rng), _frame(rng)])
    maps_before, scalars_before = multi.maps[1].clone(), multi.scalars[1].clone()
    ma_before = multi.score_ma[1]
    out = multi.process_frames([_frame(rng), None])
    assert out[0] is not None and out[1] is None
    assert torch.equal(multi.maps[1], maps_before) and torch.equal(multi.scalars[1], scalars_before)
    assert multi.score_ma[1] == ma_before and multi._task_scored == [6, 5]
    assert not torch.equal(multi.maps[0], maps_before)  # stream 0 kept updating
    with pytest.raises(ValueError):
        multi.process_frames([_frame(rng)])


def test_reset_stream(setup):
    _, model, config = setup
    multi = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=SETTINGS)
    rng = np.random.RandomState(1)
    for _ in range(4):
        multi.process_frames([_frame(rng)] * 2)
    assert float(multi.maps[0].abs().max()) > 0
    multi.reset_stream(0)
    assert float(multi.maps[0].abs().max()) == 0 and float(multi.scalars[0].abs().max()) == 0
    assert float(multi.maps[1].abs().max()) > 0
    out = multi.process_frames([_frame(rng)] * 2)  # the reset state seeds again
    assert out[0] is not None and float(multi.scalars[0, 4]) == 1.0


def test_per_stream_cdf_threshold(setup):
    """anomaly_score_method 'cdf' keeps one CDF PER STREAM, and new_task(i)
    resets only stream i's history and threshold."""
    _, model, config = setup
    settings = dict(SETTINGS, anomaly_score_method="cdf", cdf_quantile=0.9, cdf_floor=0.0,
                    cdf_warmup_abstain=False)
    multi = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=settings)
    fixed = float(settings["anomaly_score_threshold"])
    assert multi.current_threshold(0) == pytest.approx(fixed)
    assert multi.current_threshold(1) == pytest.approx(fixed)
    multi.anomaly_settings = dict(settings, cdf_warmup_abstain=True)
    assert multi.current_threshold(0) == float("inf")
    multi.anomaly_settings = settings
    rng = np.random.RandomState(0)
    multi._score_history[0].extend(rng.normal(0.0, 1.0, 200).tolist())
    multi._score_history[1].extend(rng.normal(10.0, 1.0, 200).tolist())
    multi._cdf_dirty = [99, 99]
    thr0, thr1 = multi.current_threshold(0), multi.current_threshold(1)
    assert 0.9 < thr0 < 2.3, thr0
    assert 10.9 < thr1 < 12.3, thr1
    multi.new_task(0)
    assert len(multi._score_history[0]) == 0
    assert multi.current_threshold(0) == pytest.approx(fixed)
    assert multi.current_threshold(1) == pytest.approx(thr1)


def test_per_stream_cdf_threshold_matches_jax(setup):
    from trustedai_cl_vae_ad_tpu.stream.multicam import MultiCameraEngine as JaxMulti

    jmodel, tmodel, config = setup
    settings = dict(SETTINGS, anomaly_score_method="cdf", cdf_warmup_skip=2, cdf_window=64)
    j = JaxMulti(jmodel, config, n_streams=2, anomaly_settings=dict(settings))
    t = MultiCameraEngine(tmodel, config, n_streams=2, anomaly_settings=dict(settings))
    scores = np.random.RandomState(0).standard_t(3, (2, 90))
    for n in range(90):
        for i in range(2):
            s = float(scores[i, n]) if n % 13 else float("nan")
            j._record_score(i, s)
            t._record_score(i, s)
        if n % 10 == 9:
            for i in range(2):
                assert t.current_threshold(i) == pytest.approx(j.current_threshold(i), rel=1e-12)


def test_host_resize_single_channel(setup):
    _, model, config = setup
    multi = MultiCameraEngine(model, config, n_streams=1, anomaly_settings=SETTINGS)
    gray1 = np.random.RandomState(0).randint(0, 255, (8, 8, 1), np.uint8)
    out = multi._host_resize(0, gray1, (16, 16, 3))
    assert out.shape == (16, 16, 3) and (out[..., 0] == out[..., 1]).all()
    rgb = np.random.RandomState(1).randint(0, 255, (8, 8, 3), np.uint8)
    assert multi._host_resize(0, rgb, (16, 16, 1)).shape == (16, 16, 1)


def test_mixed_resolution_streams(setup):
    """The batch shape is pinned at the first tick and a stream of another
    resolution is resized on the host: it scores like a stream that delivers
    the resized frames."""
    _, model, config = setup
    eng = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=dict(SETTINGS))
    ref = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=dict(SETTINGS))
    rng = np.random.RandomState(3)
    for t in range(4):
        f0, f1_big = _frame(rng, (20, 24, 3)), _frame(rng, (40, 48, 3))
        out = eng.process_frames([f0, f1_big], now=float(t))
        assert out[0] is not None and out[1] is not None
        f1_small = np.asarray(Image.fromarray(f1_big).resize((24, 20), Image.BILINEAR), np.uint8)
        want = ref.process_frames([f0, f1_small], now=float(t))
        np.testing.assert_allclose(out[1].score, want[1].score, atol=1e-5, equal_nan=True)
    assert eng._ref_shape == (20, 24, 3)


def test_pipelined_mode_lags_one_tick(setup):
    _, model, config = setup
    rng = np.random.RandomState(21)
    ticks = [[_frame(rng) for _ in range(2)] for _ in range(5)]
    ticks[2][0] = None  # the validity mask travels with its tick

    def run(pipelined):
        eng = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=dict(SETTINGS),
                                pipelined=pipelined)
        outs, tags = [], []
        for i, t in enumerate(ticks):
            outs.append(eng.process_frames(t, now=float(i), tag=i))
            tags.append(eng.last_emitted_tag)
        if pipelined:
            outs.append(eng.flush(now=5.0))
            tags.append(eng.last_emitted_tag)
            assert eng.flush() is None
        return [[None if r is None else (r.pixel_count, int(r.norm_err_u8.sum())) for r in out]
                for out in outs], tags

    seq_a, tags_a = run(False)
    seq_b, tags_b = run(True)
    assert seq_b[0] == [None, None] and seq_b[1:] == seq_a
    assert tags_a == [0, 1, 2, 3, 4] and tags_b == [None, 0, 1, 2, 3, 4]
    assert MultiCameraEngine(model, config, n_streams=2).flush() is None


def test_cdf_warmup_skip_and_new_task_keeps_ema(setup):
    _, model, config = setup
    settings = dict(SETTINGS, anomaly_score_method="cdf", cdf_warmup_skip=3)
    multi = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=settings)
    rng = np.random.RandomState(31)
    scores = []
    for t in range(40):
        out = multi.process_frames([_frame(rng) for _ in range(2)], now=float(t))
        scores.append(out[0].score)
    want = sum(1 for t, s in enumerate(scores) if t >= 3 and np.isfinite(s))
    assert want > 0, "fixture produced no finite scores"
    assert len(multi._score_history[0]) == want and multi._task_scored[0] == 40
    maps_before = multi.maps[0].clone()
    multi.new_task(0)  # default: the EMA state is kept
    assert len(multi._score_history[0]) == 0 and multi._task_scored[0] == 0
    assert multi.score_ma[0] == 0.0 and multi._task_scored[1] == 40
    assert torch.equal(multi.maps[0], maps_before)
    multi.new_task(0, reset_scorer=True)
    assert float(multi.maps[0].abs().max()) == 0
    multi.new_task()  # all streams
    assert multi._task_scored == [0, 0]


def test_no_anomaly_settings_scores_without_state_machine(setup):
    _, model, config = setup
    multi = MultiCameraEngine(model, config, n_streams=2)
    rng = np.random.RandomState(3)
    for t in range(3):
        out = multi.process_frames([_frame(rng) for _ in range(2)], now=float(t))
    assert multi.current_threshold(0) is None
    assert all(isinstance(r, StreamStatus) and not r.anomalous for r in out)
    with pytest.raises(ValueError, match="missing"):
        MultiCameraEngine(model, config, n_streams=2, anomaly_settings={"x": 1})
    with pytest.raises(ValueError):
        MultiCameraEngine(model, config, n_streams=0)


def test_state_machine_holds_and_expires(setup):
    _, model, config = setup
    multi = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=dict(SETTINGS))
    multi._update_state_machine(1, 5.0, now=1.0)
    assert list(multi.anomalous) == [False, True] and multi.anomalous_start[1] == 1.0
    multi._update_state_machine(1, 0.0, now=1.01)
    assert multi.anomalous[1]  # held
    multi._update_state_machine(1, 0.0, now=1.1)
    assert not multi.anomalous[1]


def test_warmup_pin_survives_all_dropped_tick(setup, capsys):
    """The warm-up's shape pin is provisional: an all-dropped first tick does
    not confirm it, and the first delivered frame re-pins to its resolution.
    The warm-up leaves the scorer state untouched."""
    _, model, config = setup
    multi = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=dict(SETTINGS))
    multi.warmup(frame_shape=(32, 32, 3))
    assert multi._warm_pin and multi._ref_shape == (32, 32, 3)
    assert float(multi.maps.abs().max()) == 0 and float(multi.scalars.abs().max()) == 0
    out = multi.process_frames([None, None], now=0.0)  # cameras still connecting
    assert out == [None, None] and multi._warm_pin
    multi.process_frames([np.full((16, 16, 3), 128, np.uint8), None], now=1.0)
    assert not multi._warm_pin and multi._ref_shape == (16, 16, 3)
    assert "re-pinning" in capsys.readouterr().out
    native = MultiCameraEngine(model, config, n_streams=2)
    native.warmup()
    assert native._ref_shape == (16, 16, 3)
    native.process_frames([np.full((16, 16, 3), 128, np.uint8)] * 2)
    assert not native._warm_pin


# -- int8 serving ---------------------------------------------------------------------------

def test_multicam_quantized_matches_float():
    """MultiCameraEngine(quantize=True) tracks the float engine on a static
    scene with small noise: finite moving averages, the same alarm decisions,
    and both alarm on a large blob (the tiny model's Dense kernels are
    quantized through a patched threshold)."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    config = tiny_config(image=(64, 48, 3), layers=(4, 8), latent=8, ddf=8)
    model = load_model_from_config(config, seed=0, device="cpu")
    frames = _scene_ticks(2, 8, shape=(64, 48, 3))
    f_eng = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=dict(SETTINGS))
    with mock.patch.object(quant, "DEFAULT_MIN_ELEMS", 0):
        q_eng = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=dict(SETTINGS),
                                  quantize=True)
    assert q_eng.quantized and quant._is_qdense(q_eng._serve_params["encoder"]["Dense_0"])
    assert not f_eng.quantized
    for t, tick in enumerate(frames):
        f_out = f_eng.process_frames(tick, now=float(t))
        q_out = q_eng.process_frames(tick, now=float(t))
    for i in range(2):
        assert np.isfinite(q_out[i].score_ma) and np.isfinite(f_out[i].score_ma)
        assert q_out[i].anomalous == f_out[i].anomalous
        assert int(np.abs(q_out[i].reconstruction_u8.astype(int)
                          - f_out[i].reconstruction_u8.astype(int)).max()) <= 2
    blob = [t.copy() for t in frames[-1]]
    for b in blob:
        b[10:50, 10:40, :] = 255
    f_blob, q_blob = f_eng.process_frames(blob, now=9.0), q_eng.process_frames(blob, now=9.0)
    for i in range(2):
        assert f_blob[i].score > f_out[i].score and q_blob[i].score > q_out[i].score


def test_multicam_serves_a_prequantized_tree(setup, tmp_path):
    """qparams= (the int8-checkpoint boot): the engine serves the given tree
    from a model shell without float parameters."""
    from trustedai_cl_vae_ad_tpu_torch.config import save_config

    _, model, config = setup
    d = str(tmp_path / "logdir")
    os.makedirs(d)
    save_config(config, os.path.join(d, "config.yml"))
    quant.save_quantized_checkpoint(d, quant.quantize_params(model.core, model.params,
                                                             min_elems=0))
    booted, cfg = quant.load_int8_serving_model(d, device="cpu", log=lambda m: None)
    eng = MultiCameraEngine(booted, cfg, n_streams=2, qparams=booted.qparams)
    ref = MultiCameraEngine(model, config, n_streams=2,
                            qparams=quant.quantize_params(model.core, model.params, min_elems=0))
    rng = np.random.RandomState(5)
    for t in range(3):
        tick = [_frame(rng), _frame(rng)]
        a, b = eng.process_frames(tick, now=float(t)), ref.process_frames(tick, now=float(t))
    assert eng.quantized and booted.params is None
    assert [r.pixel_count for r in a] == [r.pixel_count for r in b]
    np.testing.assert_array_equal(a[0].reconstruction_u8, b[0].reconstruction_u8)


# -- the surfaces that used to raise -----------------------------------------------------

def test_unported_surfaces_raise_and_name_their_item(setup, tmp_path):
    """Fleet continual learning, its replay buffer, recording and autosave,
    which raised NotImplementedError before, are ported
    (tests/test_torch_multicam_cl.py holds them to the JAX engine), and so is
    the device mesh (tests/test_torch_multicam_mesh.py): what is not a
    one-process Mesh is refused with a TypeError, a mesh of ranks with a
    ValueError. An engine that never uses a CL control allocates no
    optimizer."""
    _, model, config = setup
    multi = MultiCameraEngine(model, config, n_streams=2)
    assert multi.enable_cont_learning is False
    multi.enable_cont_learning = False  # the CLI's default assignment is accepted
    assert multi._cl_ring is None and model.optimizer is None
    (tmp_path / "rec").mkdir()
    inst = multi.begin_recording(str(tmp_path / "rec"), names=["a", "a"])
    assert multi._stream_names == ["a", "a_1"] and sorted(os.listdir(inst)) == ["a", "a_1"]
    multi.recording_flag = False
    assert multi.load_replay_buffer_from_filelist([str(tmp_path / "missing.png")]) == 0
    cached = MultiCameraEngine(model, config, n_streams=2, model_cache_dir=str(tmp_path / "c"))
    assert cached.model_cache_dir == str(tmp_path / "c") and not cached.schedule_model_save_flag
    assert cached.cl_ring_ticks == 4 and cached.continuous_learning_period_ms == 500.0
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        MultiCameraEngine(model, config, n_streams=2, mesh=object())
    with pytest.raises(ValueError, match="one process"):
        MultiCameraEngine(model, config, n_streams=2,
                          mesh=Mesh(2, 1, ["cpu"], distributed=True))
    assert model.optimizer is None


# -- the run loop and the CLI -----------------------------------------------------------------

class _ListSource:
    """A replayable source over a list of frames."""
    is_live = False

    def __init__(self, frames):
        self.frames, self.i, self.exhausted, self.released = list(frames), 0, False, False

    def read(self):
        if self.i >= len(self.frames):
            self.exhausted = True
            return None
        self.i += 1
        return self.frames[self.i - 1]

    def release(self):
        self.released = True


def test_paced_reader_repeats_frames_of_a_slower_source():
    """A 10 fps source under a 20 fps tick is read every second tick and
    repeats its latest frame in between; a source at the tick rate is read
    every tick; both end with None."""
    slow = PacedReader(_ListSource([1, 2, 3]), fps=10.0, tick_fps=20.0)
    fast = PacedReader(_ListSource([1, 2, 3]), fps=20.0, tick_fps=20.0)
    assert [slow.read() for _ in range(7)] == [1, 2, 2, 3, 3, None, None]
    assert [fast.read() for _ in range(5)] == [1, 2, 3, None, None]
    slow.release()
    assert slow.source.released


class _LiveSource(_ListSource):
    """A live source: every read blocks for a moment, as a camera does."""
    is_live = True

    def read(self):
        import time

        time.sleep(0.005)
        return super().read()


def test_paced_reader_drains_a_live_source_on_a_thread():
    """A live source is read on its own thread: the tick gets the newest
    frame without waiting, None before the first frame and once the source
    has ended, and release stops the thread before the capture is released."""
    import time

    reader = PacedReader(_LiveSource(list(range(1, 9))), fps=30.0, tick_fps=20.0)
    seen = []
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        f = reader.read()
        if f is None and (reader._drain.dead or reader.source.exhausted):
            break
        seen.append(f)
        time.sleep(0.002)
    assert reader._drain.dead, "the drain thread did not end with its source"
    frames = [f for f in seen if f is not None]
    assert frames and frames == sorted(frames) and frames[-1] == 8  # newest frames, in order
    assert reader.read() is None
    reader.release()
    assert reader.source.released and not reader._drain._thread.is_alive()


class _DroppingReader:
    """Delivers a frame on every tick but each ``every``-th."""

    def __init__(self, frames, every):
        self.frames, self.every, self.i, self.released = frames, every, 0, False

    def read(self):
        self.i += 1
        if self.i > len(self.frames):
            return None
        return None if self.i % self.every == 0 else self.frames[self.i - 1]

    def release(self):
        self.released = True


@pytest.mark.parametrize("pipelined", [False, True], ids=["plain", "pipelined"])
def test_run_all_cameras_loop(setup, tmp_path, pipelined):
    """The multi-camera loop: per-tick stats lines with the scored tick's tag,
    None for a stream that dropped the tick, the flushed last tick in
    pipelined mode, readers released, the loop ending when no reader has a
    frame."""
    _, model, config = setup
    rng = np.random.RandomState(2)
    frames = [[_frame(rng) for _ in range(6)] for _ in range(2)]
    readers = [PacedReader(_ListSource(frames[0]), 20.0, 20.0), _DroppingReader(frames[1], 3)]
    engine = MultiCameraEngine(model, config, n_streams=2, anomaly_settings=dict(SETTINGS),
                               pipelined=pipelined)
    stats = tmp_path / "ticks.jsonl"
    seen = []
    summary = run_all_cameras(engine, readers, ["a", "b"], stats_jsonl=str(stats),
                              on_tick=lambda tick, results: seen.append((tick, results)),
                              log=lambda m: None)
    assert summary["ticks"] == 6 and summary["streams"] == 2 and len(summary["latencies_ms"]) == 6
    assert {"p50_ms", "p95_ms", "mean_ms", "rss_mb"} <= set(summary)
    assert readers[0].source.released and readers[1].released
    rows = [json.loads(line) for line in stats.read_text().splitlines()]
    assert [r["tick"] for r in rows] == [0, 1, 2, 3, 4, 5]
    assert bool(rows[-1].get("flushed")) == pipelined
    for r in rows:
        assert (r["scores"][1] is None) == (r["tick"] in (2, 5)), r
        assert r["scores"][0] is None or isinstance(r["scores"][0], float)
    assert [t for t, _ in seen] == ([None] if pipelined else []) + [0, 1, 2, 3, 4, 5]
    limited = run_all_cameras(
        MultiCameraEngine(model, config, n_streams=1), [PacedReader(_ListSource(frames[0]), 20, 20)],
        ["a"], max_frames=2, log=lambda m: None)
    assert limited["ticks"] == 2


def test_camera_streamer_torch_all_cameras_cli(tmp_path):
    """camera_streamer_torch.py --all-cameras --n-streams 3 --quantize on the
    CPU: three synthetic cameras through one int8 tick; with -c (refused
    before fleet CL was ported) the fleet takes CL steps, re-quantizing its
    serving copy, and writes their metrics under the model cache."""
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(
        "data:\n  image_size: [32, 48, 3]\n"
        "loss: {kurtosis: 1.8, w_kl_divergence: 0.0, w_kurtosis: 1.0e-4, w_mse: 1.0,"
        " w_skew: 0.0, w_z_l1_reg: 0.0}\n"
        "model:\n  type: KurtosisGlobal\n  latent_dimensions: 8\n  layers: [4, 8]\n"
        "  decoder_dense_filters: 4\n"
        "training: {batch_size: 8, beta: 1.0e-6, learning_rate: 1.0e-3, max_epochs: 1}\n")
    stats = tmp_path / "ticks.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO, TCVAE_QUANT_MIN_ELEMS="0")
    base = [sys.executable, os.path.join(REPO, "camera_streamer_torch.py"), "--device", "cpu",
            "--config", str(cfg), "--source", "synthetic", "--all-cameras", "--n-streams", "3",
            "--quantize", "--max-frames", "4"]
    proc = subprocess.run(base + ["--stats-jsonl", str(stats), "--pipelined", "--warmup",
                                  "240x320"],
                          capture_output=True, text=True, timeout=180, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in stats.read_text().splitlines()]
    assert [r["tick"] for r in rows] == [0, 1, 2, 3] and rows[-1]["flushed"]
    assert all(len(r["scores"]) == 3 for r in rows)
    assert "processed 4 ticks x 3 streams" in proc.stdout and "warming up" in proc.stdout
    assert "jax" not in proc.stderr.lower()
    proc = subprocess.run(base + ["-c"], capture_output=True, text=True, timeout=180,
                          cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr
    # the CL clock starts at 0, so the first tick steps; later ones on the wall clock
    steps = int(re.search(r"fleet continual learning: (\d+) steps", proc.stdout).group(1))
    records = (tmp_path / "model_cache" / "metrics" / "metrics.jsonl").read_text().splitlines()
    assert steps >= 1 and len(records) == steps and "cl/loss" in json.loads(records[0])
