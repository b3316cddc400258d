"""The port's MultiCameraEngine on a device mesh (``mesh=``) against the JAX
engine on its mesh, and against its own run without a mesh.

The tiny config of tests/test_torch_multicam*.py (16x16x3, layers [4],
latent 4, KurtosisSingle) and K = 16 streams. The JAX engine runs with
``make_mesh()`` over the 8 virtual CPU devices that tests/conftest.py sets
up, as tests/test_multicam.py::test_mesh_sharded_equivalence does; the port's
over ``make_mesh(devices=["cpu"] * R)``: R blocks of K/R streams on one
device, so that the split, the per-block state and the joins all run. Both
engines take the same seeded uint8 ticks and, for the CL step, the same
latent noise (the JAX step's, given to the port's step).

Tolerances: the JAX test's between its mesh and no mesh, scores rtol 1e-5
(NaN where either is NaN), the CL loss rtol 1e-5, parameters after the step
rtol 1e-4 / atol 1e-6; the same between the port's mesh and no-mesh runs.
The port's w8a8 mesh run is held to its own no-mesh run: counts equal and
scores at rtol 1e-5 (each block's int8 products are exact, its activation
scales are per row).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_helpers import next_jax_eps, paired_models, tiny_config
from trustedai_cl_vae_ad_tpu_torch.bridge import params_to_flax
from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import Mesh, make_mesh
from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine
from trustedai_cl_vae_ad_tpu_torch.testing import warm_score_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = {"anomaly_score_threshold": 2.0, "anomaly_score_method": "zz_count",
            "buffer_record_period_s": 1.0, "anomalous_state_period_s": 0.05}
CONFIG = tiny_config(image=(16, 16, 3), layers=(4,), latent=4, ddf=4,
                     model_type="KurtosisSingle")
K = 16
RING = 2
REPLAY = 3  # frames in the replay file; capacity 8 divides over 8 JAX devices and every R
NOW = (0.1, 0.2, 1.0)  # the third tick fires the CL step (period 500 ms)


def _ticks(seed=23, shape=(16, 16, 3)):
    """Three ticks of K frames; on the second, a stream of the first block and
    one of the last drop."""
    rng = np.random.RandomState(seed)
    ticks = [[rng.randint(0, 255, shape, np.uint8) for _ in range(K)] for _ in range(3)]
    ticks[1][3] = ticks[1][13] = None
    return ticks


def _model(seed=2):
    return paired_models(CONFIG, seed=seed, compile=False)[1]


def _mesh(replicas):
    return None if replicas is None else make_mesh(devices=["cpu"] * replicas)


def _inject_eps(engine, eps):
    """The port's CL step takes the latent noise ``eps`` (its first rows)."""
    if engine.mesh is not None:
        engine._cl_eps = lambda n: torch.from_numpy(eps[:n])
        return
    step = engine.model.train_step_and_run

    def with_eps(x, eps_=None, weights=None):
        return step(x, eps=torch.from_numpy(eps[:x.shape[0]]), weights=weights)

    engine.model.train_step_and_run = with_eps


def _leaves(tree):
    for part in ("encoder", "decoder"):
        for layer, leaves in tree[part].items():
            for leaf, arr in leaves.items():
                yield f"{part}/{layer}/{leaf}", np.asarray(arr)


def _warm_port(engine):
    """Start from testing.py's warm scorer state (a fresh state's first count
    is float32 rounding noise, which the two packages round apart)."""
    maps, scalars = warm_score_state(16, 16)
    engine.maps = torch.from_numpy(np.stack([maps] * engine.n_streams))
    engine.scalars = torch.from_numpy(np.stack([scalars] * engine.n_streams))


def _scores(outs):
    return np.asarray([[np.nan if r is None else r.score for r in out] for out in outs],
                      np.float64)


@pytest.fixture(scope="module")
def replay_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay")
    rng = np.random.RandomState(15)
    paths = []
    for i in range(REPLAY):
        p = str(d / f"replay{i}.png")
        Image.fromarray(rng.randint(0, 255, (20, 24, 3), np.uint8)).save(p)
        paths.append(p)
    listfile = str(d / "replay.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(paths) + "\n")
    return listfile


_JAX_RUNS = {}


def _jax_run(replay, replay_file):
    """The JAX engine on its 8-device mesh: scores, the CL loss, the
    parameters after the step and the latent noise it drew (cached a mode)."""
    if replay in _JAX_RUNS:
        return _JAX_RUNS[replay]
    from trustedai_cl_vae_ad_tpu.parallel.mesh import batch_sharding
    from trustedai_cl_vae_ad_tpu.parallel.mesh import make_mesh as jax_mesh
    from trustedai_cl_vae_ad_tpu.stream.multicam import MultiCameraEngine as JaxMulti

    jmodel, _ = paired_models(CONFIG, seed=2, compile=False)
    mesh = jax_mesh()
    assert mesh.devices.size == 8
    engine = JaxMulti(jmodel, CONFIG, n_streams=K, anomaly_settings=dict(SETTINGS),
                      cl_ring_ticks=RING, replay_capacity=8, mesh=mesh)
    if replay:
        assert engine.load_replay_buffer_from_file(replay_file) == REPLAY
    maps, scalars = warm_score_state(16, 16)
    engine.maps = jax.device_put(np.stack([maps] * K), batch_sharding(mesh))
    engine.scalars = jax.device_put(np.stack([scalars] * K), batch_sharding(mesh))
    engine.enable_cont_learning = True
    outs, eps = [], None
    for i, (tick, now) in enumerate(zip(_ticks(), NOW)):
        if i == 2:
            eps = next_jax_eps(engine.model, RING * K + (8 if replay else 0))
        outs.append(engine.process_frames(tick, now=now))
    assert engine.cl_epochs == 1
    _JAX_RUNS[replay] = (_scores(outs), engine.last_epoch_loss,
                         dict(_leaves(jax.device_get(engine.model.params))), eps)
    return _JAX_RUNS[replay]


def _port_run(replicas, replay, replay_file, eps, **kwargs):
    engine = MultiCameraEngine(_model(), CONFIG, n_streams=K, anomaly_settings=dict(SETTINGS),
                               cl_ring_ticks=RING, replay_capacity=8, mesh=_mesh(replicas),
                               **kwargs)
    if replay:
        assert engine.load_replay_buffer_from_file(replay_file) == REPLAY
    _warm_port(engine)
    engine.enable_cont_learning = True
    _inject_eps(engine, eps)
    outs = [engine.process_frames(tick, now=now) for tick, now in zip(_ticks(), NOW)]
    assert engine.cl_epochs == 1
    return engine, _scores(outs)


def _assert_params_close(got, want):
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("replay", [False, True], ids=["ring", "replay"])
@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_mesh_matches_jax_mesh_engine(replicas, replay, replay_file):
    """Three ticks with a dropped stream in two blocks and the fleet CL step
    on the third: scores, the CL loss and the parameters after the step equal
    the JAX engine's on its 8-device mesh and the port's own without a mesh.
    The engine keeps each block's state on its device, and the step leaves
    every replica equal to the trained parameters."""
    jscores, jloss, jparams, eps = _jax_run(replay, replay_file)
    engine, scores = _port_run(replicas, replay, replay_file, eps)
    alone, alone_scores = _port_run(None, replay, replay_file, eps)
    assert len(engine._maps) == len(engine._cl_rings) == replicas
    assert tuple(engine._maps[0].shape) == (K // replicas, 2, 16, 16)
    assert tuple(engine._cl_rings[0].shape) == (RING, K // replicas, 16, 16, 3)
    np.testing.assert_array_equal(engine._cl_valid, alone._cl_valid)
    assert engine._cl_valid[1, 3] == engine._cl_valid[1, 13] == 0  # tick 1 sits in slot 1
    torch.testing.assert_close(engine._cl_ring, alone._cl_ring, rtol=0, atol=0)
    for ref in (jscores, alone_scores):
        np.testing.assert_allclose(scores, ref, rtol=1e-5, equal_nan=True)
    assert np.isnan(scores[1, 3]) and np.isnan(scores[1, 13])
    assert np.isfinite(scores).sum() == 3 * K - 2  # every frame that came is scored
    for ref in (jloss, alone.last_epoch_loss):
        assert set(engine.last_epoch_loss) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(engine.last_epoch_loss[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    got = dict(_leaves(params_to_flax(engine.model.params)))
    _assert_params_close(got, jparams)
    _assert_params_close(got, dict(_leaves(params_to_flax(alone.model.params))))
    for replica in engine._param_replicas:
        for k, v in replica.items():
            assert torch.equal(v, engine.model.params[k]), k


@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_replay_capacity_rounds_to_the_mesh(replicas, replay_file):
    """The replay buffer's capacity rounds up to a multiple of the mesh's
    devices (the JAX engine's rule), its rows split in blocks over them; the
    joined buffer is the no-mesh engine's, zero-padded."""
    engine = MultiCameraEngine(_model(), CONFIG, n_streams=K, replay_capacity=6,
                               mesh=_mesh(replicas))
    alone = MultiCameraEngine(_model(), CONFIG, n_streams=K, replay_capacity=6)
    for e in (engine, alone):
        assert e.load_replay_buffer_from_file(replay_file) == REPLAY
    want = -(-6 // replicas) * replicas
    assert engine.replay_capacity == want and alone.replay_capacity == 6
    assert [b.shape[0] for b in engine._replay_blocks] == [want // replicas] * replicas
    joined = engine.replay_buffer
    assert tuple(joined.shape) == (want, 16, 16, 3)
    torch.testing.assert_close(joined[:6], alone.replay_buffer, rtol=0, atol=0)
    assert float(joined[REPLAY:].abs().max()) == 0.0


@pytest.mark.parametrize("replicas", [2, 4])
def test_w8a8_mesh_matches_no_mesh(replicas, monkeypatch):
    """int8 serving on the mesh: every block's forward reads its replica of
    the quantized tree; the scores equal the no-mesh w8a8 run's, before and
    after a fleet CL step, which quantizes again and replicates the tree."""
    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    monkeypatch.setattr(quant, "DEFAULT_MIN_ELEMS", 0)  # the tiny model's Dense kernels
    eps = np.random.RandomState(4).randn(RING * K, 4).astype(np.float32)
    runs = {}
    for name, r in (("mesh", replicas), ("alone", None)):
        engine = MultiCameraEngine(_model(), CONFIG, n_streams=K, anomaly_settings=dict(SETTINGS),
                                   cl_ring_ticks=RING, quantize=True, mesh=_mesh(r))
        assert "kernel_i8" in engine._serve_params["decoder"]["Dense_0"]
        assert len(engine._serve_replicas) == (r or 1)
        engine.enable_cont_learning = True
        _inject_eps(engine, eps)
        ticks = _ticks(seed=5) + _ticks(seed=6)[:2]
        outs = [engine.process_frames(t, now=n) for t, n in zip(ticks, NOW + (1.1, 1.2))]
        assert engine.cl_epochs == 1
        runs[name] = (engine, outs)
    (mesh, got), (alone, ref) = runs["mesh"], runs["alone"]
    counts = [[None if r is None else r.pixel_count for r in out] for out in got]
    assert counts == [[None if r is None else r.pixel_count for r in out] for out in ref]
    np.testing.assert_allclose(_scores(got), _scores(ref), rtol=1e-5, equal_nan=True)
    for tree in mesh._serve_replicas:  # re-quantized from the trained weights
        for part, layers in alone._serve_params.items():
            for layer, leaves in layers.items():
                for leaf, t in leaves.items():
                    torch.testing.assert_close(tree[part][layer][leaf], t, rtol=1e-5, atol=1e-7)


def test_pipelined_mesh_matches_no_mesh():
    """pipelined=True on a mesh keeps its one-tick lag: each call returns the
    previous tick's results, flush the last, as without a mesh."""
    def run(mesh):
        engine = MultiCameraEngine(_model(), CONFIG, n_streams=K, anomaly_settings=dict(SETTINGS),
                                   pipelined=True, mesh=mesh)
        outs = [engine.process_frames(t, now=float(i), tag=i)
                for i, t in enumerate(_ticks(seed=8))]
        outs.append(engine.flush(now=5.0))
        return engine, outs

    (engine, got), (_, ref) = run(_mesh(4)), run(None)
    assert got[0] == [None] * K and engine.last_emitted_tag == 2
    np.testing.assert_allclose(_scores(got[1:]), _scores(ref[1:]), rtol=1e-5, equal_nan=True)
    for a, b in zip(got[1:], ref[1:]):
        for ra, rb in zip(a, b):
            assert (ra is None) == (rb is None)
            if ra is not None:
                np.testing.assert_array_equal(ra.reconstruction_u8, rb.reconstruction_u8)


def test_reset_and_new_task_on_the_second_block():
    """reset_stream and new_task act on the rows of the block that holds the
    stream: stream 13 of 16 over 2 blocks is row 5 of the second block."""
    def run(mesh):
        engine = MultiCameraEngine(_model(), CONFIG, n_streams=K, anomaly_settings=dict(
            SETTINGS, anomaly_score_method="cdf"), mesh=mesh)
        ticks = _ticks(seed=9) + _ticks(seed=10)
        outs = []
        for i, t in enumerate(ticks):
            if i == 2:
                engine.reset_stream(13)
                if engine.mesh is not None:
                    assert float(engine._maps[1][5].abs().sum()) == 0.0
                    assert float(engine._scalars[1][5].abs().sum()) == 0.0
                    assert float(engine._maps[1][4].abs().sum()) > 0.0
                    assert float(engine._maps[0][5].abs().sum()) > 0.0
            if i == 4:
                engine.new_task(13)
                assert engine.score_ma[13] == 0.0 and not engine._score_history[13]
            outs.append(engine.process_frames(t, now=float(i)))
        return engine, outs

    (engine, got), (alone, ref) = run(_mesh(2)), run(None)
    np.testing.assert_allclose(_scores(got), _scores(ref), rtol=1e-5, equal_nan=True)
    torch.testing.assert_close(engine.maps, alone.maps, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(engine.scalars, alone.scalars, rtol=1e-5, atol=1e-6)


def test_mesh_refusals():
    """A stream count that does not divide over the mesh's devices, a mesh of
    ranks, a mesh whose first device is not the model's and what is not a
    Mesh are refused."""
    model = _model()
    with pytest.raises(ValueError, match="n_streams 6 must divide over 4 devices"):
        MultiCameraEngine(model, CONFIG, n_streams=6, mesh=_mesh(4))
    with pytest.raises(ValueError, match="one process"):
        MultiCameraEngine(model, CONFIG, n_streams=4, mesh=Mesh(2, 1, ["cpu"], distributed=True))
    with pytest.raises(ValueError, match="first device"):
        MultiCameraEngine(model, CONFIG, n_streams=4, mesh=make_mesh(devices=["meta", "cpu"]))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        MultiCameraEngine(model, CONFIG, n_streams=4, mesh=["cpu", "cpu"])
    assert model.optimizer is None


def test_run_loop_on_a_mesh_warms_records_and_autosaves(tmp_path):
    """stream/run.py's fleet loop over a 2-block mesh: warm-up with the CL
    step's backward (the parameters, the generator and the ring unchanged),
    fleet CL, per-camera recording and the autosave, which read the first
    device's parameters, the trained copy."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource
    from trustedai_cl_vae_ad_tpu_torch.stream.run import make_paced_readers, run_all_cameras

    k = 4
    engine = MultiCameraEngine(_model(), CONFIG, n_streams=k, anomaly_settings=dict(SETTINGS),
                               cl_ring_ticks=RING, continuous_learning_period_ms=0.0,
                               model_cache_dir=str(tmp_path / "cache"), autosave_period_s=0.0,
                               mesh=_mesh(2))
    before = {n: v.clone() for n, v in engine.model.params.items()}
    gen = engine.model.generator.get_state().clone()
    engine.warmup(cl=True)
    assert engine.model.optimizer.count == 0 and engine.cl_epochs == 0
    assert all(torch.equal(before[n], v) for n, v in engine.model.params.items())
    assert torch.equal(engine.model.generator.get_state(), gen)
    assert float(engine._cl_ring.abs().sum()) == 0.0
    engine.enable_cont_learning = True
    (tmp_path / "rec").mkdir()
    engine.begin_recording(str(tmp_path / "rec"))
    engine.record_period_ms = 0.0
    ticks = [0.0]

    def clock(n):
        ticks.append(ticks[-1] + 1.0)
        return ticks[-1]

    readers = [SyntheticSource(width=24, height=20, n_frames=4, seed=s) for s in range(k)]
    summary = run_all_cameras(engine, readers, [f"cam{i}" for i in range(k)], max_frames=4,
                              clock=clock, log=lambda *_: None)
    assert summary["ticks"] == 4 and engine.cl_epochs >= 2
    cache, _ = load_model_from_directory(str(tmp_path / "cache"), device="cpu")
    for n, v in engine.model.params.items():
        assert torch.equal(cache.params[n], v), n
    inst = [d for d in os.listdir(tmp_path / "rec") if d.startswith("data_")]
    assert len(inst) == 1
    root = tmp_path / "rec" / inst[0]
    for i in range(k):
        assert (root / f"cam{i}" / "labels.json").is_file()
    assert (root / "model" / "encoder").is_dir()


def test_camera_streamer_all_cameras_mesh_cpu(tmp_path):
    """camera_streamer_torch.py --all-cameras --mesh --device cpu end to end,
    with fleet CL, its warm-up and a model cache: the mesh is the one CPU
    device, and the run scores every tick."""
    from trustedai_cl_vae_ad_tpu_torch.config import save_config

    model = _model()
    mdir = str(tmp_path / "model")
    model.save_model(mdir, include_optimizer=False)
    save_config(CONFIG, os.path.join(mdir, "config.yml"))
    stats = str(tmp_path / "stats.jsonl")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "camera_streamer_torch.py"), "-m", mdir,
         "--device", "cpu", "--all-cameras", "--n-streams", "4", "--mesh", "-c", "--warmup",
         "--model-cache-dir", str(tmp_path / "cache"), "--max-frames", "5",
         "--stats-jsonl", stats],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "mesh: 1 devices, 4 streams each" in proc.stdout
    assert "processed 5 ticks x 4 streams" in proc.stdout
    assert "fleet continual learning:" in proc.stdout and "warming up" in proc.stdout
    rows = [json.loads(line) for line in open(stats)]
    assert [r["tick"] for r in rows] == list(range(5))
    assert all(len(r["scores"]) == 4 for r in rows)
