"""Offline anomaly detection in the port (``anomaly/offline.py`` and
``do_anomaly_detection_torch.py``): the cases of ``tests/test_anomaly.py``
that concern scoring, artifacts, ``histogram_only``, degenerate scales and
single-channel frames, run against the port, and its two passes and its CLI
held against the JAX package on the same saved datasets with the same
weights (through ``bridge.py``), on the CPU at a tiny config.

Tolerances: a float32 forward of the two libraries agrees at rtol 1e-5, so
per-frame errors eps (a sum of 768 squares) do too, and z = (eps - meu) /
sigma is compared at 1e-5 max|eps| / sigma. The ``w8a8`` forwards agree
within 2e-4 per output (``tests/test_torch_quant.py::
test_call_quantized_matches_jax``), which bounds a frame's eps difference by
2e-4 (2 sum|x - x_hat| + 768 * 2e-4)."""

import csv
import os
import sys

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import paired_models, tiny_config

N_TRAIN, N_EVAL = 16, 12
PIXELS = 16 * 16 * 3
Q_TOL = 2e-4


def _frames(seed, n, anomalies=()):
    rng = np.random.RandomState(seed)
    base = np.clip(rng.normal(128, 20, (n, 16, 16, 3)), 0, 255).astype(np.uint8)
    for i in anomalies:  # a bright blob
        base[i, 4:12, 4:12, :] = 255
    return base


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(config, JAX model, port model, train dir, eval dir): saved datasets of
    16 training and 12 evaluation frames (two of them with a blob)."""
    from trustedai_cl_vae_ad_tpu_torch.data.saved_dataset import save_dataset

    root = tmp_path_factory.mktemp("offline")
    train_dir, eval_dir = str(root / "train_ds"), str(root / "eval_ds")
    for path, frames in ((train_dir, _frames(0, N_TRAIN)),
                         (eval_dir, _frames(1, N_EVAL, anomalies=(3, 9)))):
        save_dataset(path, [{"image": frames,
                             "filepath": [f"f{i}.png" for i in range(len(frames))]}])
    config = tiny_config(image=(16, 16, 3), layers=(4,), latent=4, model_type="KurtosisSingle")
    config["data"]["dataset_path"] = train_dir
    jmodel, tmodel = paired_models(config, compile=False)
    return config, jmodel, tmodel, train_dir, eval_dir


def _port_data(config, path=None):
    from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data

    cfg = dict(config, data=dict(config["data"], dataset_path=path or
                                 config["data"]["dataset_path"]))
    return load_data(cfg, device="cpu")


def _jax_data(config, path=None):
    from trustedai_cl_vae_ad_tpu.data.loader import load_data

    cfg = dict(config, data=dict(config["data"], dataset_path=path or
                                 config["data"]["dataset_path"]))
    return load_data(cfg)


def _eps(scale):
    return scale["z_scores"] * scale["sigma"] + scale["meu"]


def _assert_scale_close(got, want, eps_tol):
    """meu and each frame's eps within ``eps_tol``; sigma within the std of
    the eps differences plus rounding; min and max at rtol 1e-5."""
    e_got, e_want = _eps(got), _eps(want)
    assert np.max(np.abs(e_got - e_want)) <= eps_tol
    assert abs(got["meu"] - want["meu"]) <= eps_tol
    # |std(a) - std(b)| <= std(a - b) (Minkowski), plus float32 rounding of the eps
    assert abs(got["sigma"] - want["sigma"]) <= np.std(e_got - e_want) + 1e-5 * want["meu"]
    for k in ("min", "max"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


# -- the cases of tests/test_anomaly.py, against the port ------------------------------------

def test_two_pass_scoring(setup):
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import evaluate_anomalies, get_data_scale

    config, _, model, _, _ = setup
    data = _port_data(config)
    scale = get_data_scale(model, config, data)
    assert scale["sigma"] >= 0 and scale["max"] >= scale["min"]
    assert scale["z_scores"].shape == (N_TRAIN,)
    np.testing.assert_allclose(np.mean(scale["z_scores"]), 0.0, atol=1e-5)

    results = evaluate_anomalies(model, config, data, scale, anomaly_threshold=3.0)
    assert results["z_scores"].shape == (N_TRAIN,)
    assert results["rec"].shape == (N_TRAIN, 16, 16, 3)
    assert results["norm_errs"].shape == (N_TRAIN, 16, 16)
    assert results["anomalies"].dtype == bool
    # the reference set scored against itself gives its own z-scores
    np.testing.assert_allclose(np.sort(results["z_scores"]), np.sort(scale["z_scores"]),
                               atol=1e-3)


def test_two_pass_scoring_uint8_matches_normalized_float(setup):
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import evaluate_anomalies, get_data_scale

    config, _, model, _, _ = setup
    u8 = np.random.RandomState(7).randint(0, 256, (8, 16, 16, 3)).astype(np.uint8)
    d_u8 = {"train": [u8], "val": [u8]}
    d_f32 = {"train": [u8.astype(np.float32) / 255.0], "val": [u8.astype(np.float32) / 255.0]}
    s_u8 = get_data_scale(model, config, d_u8)
    s_f32 = get_data_scale(model, config, d_f32)
    for k in ("meu", "sigma", "min", "max"):
        np.testing.assert_allclose(s_u8[k], s_f32[k], rtol=1e-5, err_msg=k)
    r_u8 = evaluate_anomalies(model, config, d_u8, s_f32, 3.0, keep_maps=False)
    r_f32 = evaluate_anomalies(model, config, d_f32, s_f32, 3.0, keep_maps=False)
    np.testing.assert_allclose(r_u8["z_scores"], r_f32["z_scores"], atol=1e-4)


def test_two_pass_scoring_quantized(setup, monkeypatch):
    """--quantize runs both passes on the w8a8 forward: decisions and the
    z-score distribution track the float pipeline (the JAX test's
    tolerances)."""
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import evaluate_anomalies, get_data_scale
    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    config, _, model, _, eval_dir = setup
    data, evaluation = _port_data(config), _port_data(config, eval_dir)
    scale_f = get_data_scale(model, config, data)
    res_f = evaluate_anomalies(model, config, evaluation, scale_f, 3.0, keep_maps=False)
    monkeypatch.setattr(quant, "DEFAULT_MIN_ELEMS", 0)
    monkeypatch.delenv("TCVAE_QUANT_MIN_ELEMS", raising=False)
    _, tree = quant.serving_forward(model.core, model.params, quantize=True)
    assert quant._is_qdense(tree["encoder"]["Dense_0"]) and quant._is_qdense(
        tree["decoder"]["Dense_0"])
    scale_q = get_data_scale(model, config, data, quantize=True, score_params=tree)
    res_q = evaluate_anomalies(model, config, evaluation, scale_q, 3.0, keep_maps=False,
                               quantize=True, score_params=tree)
    np.testing.assert_allclose(scale_q["meu"], scale_f["meu"], rtol=0.02)
    np.testing.assert_array_equal(res_q["anomalies"], res_f["anomalies"])
    np.testing.assert_allclose(res_q["z_scores"], res_f["z_scores"], atol=0.25)


def test_output_artifacts(setup, tmp_path):
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import (
        evaluate_anomalies,
        get_data_scale,
        output_anomalies,
    )

    config, _, model, _, _ = setup
    data = _port_data(config)
    scale = get_data_scale(model, config, data)
    results = evaluate_anomalies(model, config, data, scale, 3.0)
    out = tmp_path / "anomaly_out"
    out.mkdir()
    output_anomalies(data, results, scale, str(out), 3.0)
    assert (out / "anomaly_fig.png").exists()
    for sub in ("err", "heatmap", "overlay", "rec", "orig"):
        assert len(list((out / sub).glob("*.png"))) == N_TRAIN, sub
    rows = (out / "anomaly_list.csv").read_text().strip().splitlines()
    assert rows[0] == "orig_filepath,z_score" and len(rows) == N_TRAIN + 1
    zs = [float(r.split(",")[1]) for r in rows[1:]]
    assert zs == sorted(zs, reverse=True)


def test_streamed_artifacts_match_accumulated(setup, tmp_path):
    """artifact_path mode (O(batch) host memory) writes the same artifacts
    and CSV as the accumulate-everything path."""
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import (
        evaluate_anomalies,
        get_data_scale,
        output_anomalies,
    )

    config, _, model, _, _ = setup
    data = _port_data(config)
    scale = get_data_scale(model, config, data)
    out_s, out_a = tmp_path / "streamed", tmp_path / "accumulated"
    out_s.mkdir()
    out_a.mkdir()
    results_s = evaluate_anomalies(model, config, data, scale, 3.0, keep_maps=False,
                                   artifact_path=str(out_s))
    assert "rec" not in results_s and len(results_s["orig_paths"]) == N_TRAIN
    output_anomalies(data, results_s, scale, str(out_s), 3.0)
    results_a = evaluate_anomalies(model, config, data, scale, 3.0)
    output_anomalies(data, results_a, scale, str(out_a), 3.0)
    for sub in ("err", "heatmap", "overlay", "rec", "orig"):
        fs = sorted(p.name for p in (out_s / sub).glob("*.png"))
        assert fs == sorted(p.name for p in (out_a / sub).glob("*.png")) and len(fs) == N_TRAIN
        for name in fs:
            assert (out_s / sub / name).read_bytes() == (out_a / sub / name).read_bytes()
    assert _csv_rows(out_s) == _csv_rows(out_a)


def test_histogram_only(setup, tmp_path):
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import (
        evaluate_anomalies,
        get_data_scale,
        output_anomalies,
    )

    config, _, model, _, _ = setup
    data = _port_data(config)
    scale = get_data_scale(model, config, data)
    results = evaluate_anomalies(model, config, data, scale, 3.0, keep_maps=False)
    out = tmp_path / "hist_only"
    out.mkdir()
    output_anomalies(data, results, scale, str(out), 3.0, histogram_only=True)
    assert (out / "anomaly_fig.png").exists()
    assert not (out / "err").exists() and not (out / "anomaly_list.csv").exists()


def test_dump_frame_single_channel(tmp_path):
    """(H, W, 1) frames of single-channel models write all five PNGs, the
    same bytes as the JAX package's."""
    from trustedai_cl_vae_ad_tpu.anomaly import offline as joffline
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import _artifact_dirs, _dump_frame

    rng = np.random.RandomState(0)
    x, rec = rng.rand(8, 8, 1).astype(np.float32), rng.rand(8, 8, 1).astype(np.float32)
    norm_err = rng.rand(8, 8).astype(np.float32)
    dirs = _artifact_dirs(str(tmp_path / "port"))
    assert os.path.exists(_dump_frame(dirs, 0, x, rec, norm_err))
    jdirs = joffline._artifact_dirs(str(tmp_path / "jax"))
    joffline._dump_frame(jdirs, 0, x, rec, norm_err)
    for name, d in dirs.items():
        (f,) = os.listdir(d)
        with open(os.path.join(d, f), "rb") as a, open(os.path.join(jdirs[name], f), "rb") as b:
            assert a.read() == b.read(), name


def test_degenerate_scale_yields_finite_z(setup):
    """sigma = 0 and flat error maps (a one-frame reference set) give finite
    z-scores and maps, equal to the JAX package's."""
    from trustedai_cl_vae_ad_tpu.anomaly.offline import evaluate_anomalies as jax_evaluate
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import evaluate_anomalies

    config, jmodel, model, _, _ = setup
    scale = {"meu": 5.0, "sigma": 0.0, "min": 2.0, "max": 2.0, "z_scores": np.zeros(1)}
    res = evaluate_anomalies(model, config, _port_data(config), scale, 3.0, keep_maps=True)
    assert np.isfinite(res["z_scores"]).all() and np.isfinite(res["norm_errs"]).all()
    want = jax_evaluate(jmodel, config, _jax_data(config), scale, 3.0, keep_maps=True)
    eps_max = float(np.max(np.abs(want["z_scores"]))) + 5.0
    np.testing.assert_allclose(res["z_scores"], want["z_scores"], rtol=1e-5,
                               atol=1e-5 * eps_max)


# -- parity with the JAX package ---------------------------------------------------------------

def test_get_data_scale_matches_jax(setup):
    from trustedai_cl_vae_ad_tpu.anomaly.offline import get_data_scale as jax_scale
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import get_data_scale

    config, jmodel, model, _, _ = setup
    want = jax_scale(jmodel, config, _jax_data(config))
    got = get_data_scale(model, config, _port_data(config))
    _assert_scale_close(got, want, eps_tol=1e-5 * float(np.max(_eps(want))))
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=1e-4)
    np.testing.assert_allclose(got["z_scores"], want["z_scores"], rtol=0,
                               atol=1e-5 * float(np.max(_eps(want))) / want["sigma"])


def test_evaluate_anomalies_matches_jax(setup):
    from trustedai_cl_vae_ad_tpu.anomaly.offline import evaluate_anomalies as jax_evaluate
    from trustedai_cl_vae_ad_tpu.anomaly.offline import get_data_scale as jax_scale
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import evaluate_anomalies

    config, jmodel, model, _, eval_dir = setup
    scale = jax_scale(jmodel, config, _jax_data(config))
    want = jax_evaluate(jmodel, config, _jax_data(config, eval_dir), scale, 3.0)
    got = evaluate_anomalies(model, config, _port_data(config, eval_dir), scale, 3.0)
    z_tol = 1e-5 * float(np.max(_eps(scale))) / scale["sigma"]
    np.testing.assert_allclose(got["z_scores"], want["z_scores"], rtol=0, atol=z_tol)
    np.testing.assert_array_equal(got["anomalies"], want["anomalies"])
    assert got["anomalies"][[3, 9]].all() and got["anomalies"].sum() == 2  # the two blobs
    for key in ("rec", "errs", "norm_errs"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_quantized_passes_match_jax(setup, monkeypatch):
    """Both packages quantize the same weights (int8 values equal,
    tests/test_torch_quant.py) and score with w8a8: eps within the bound
    that the forwards' 2e-4 gives."""
    from trustedai_cl_vae_ad_tpu.anomaly.offline import evaluate_anomalies as jax_evaluate
    from trustedai_cl_vae_ad_tpu.anomaly.offline import get_data_scale as jax_scale
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import evaluate_anomalies, get_data_scale

    config, jmodel, model, _, eval_dir = setup
    monkeypatch.setenv("TCVAE_QUANT_MIN_ELEMS", "0")
    want = jax_scale(jmodel, config, _jax_data(config), quantize=True)
    got = get_data_scale(model, config, _port_data(config), quantize=True)
    eps_tol = Q_TOL * (2 * PIXELS + PIXELS * Q_TOL)
    _assert_scale_close(got, want, eps_tol)
    res_w = jax_evaluate(jmodel, config, _jax_data(config, eval_dir), want, 3.0,
                         keep_maps=False, quantize=True)
    res_g = evaluate_anomalies(model, config, _port_data(config, eval_dir), want, 3.0,
                               keep_maps=False, quantize=True)
    np.testing.assert_allclose(res_g["z_scores"], res_w["z_scores"], rtol=0,
                               atol=eps_tol / want["sigma"])
    np.testing.assert_array_equal(res_g["anomalies"], res_w["anomalies"])


def test_mesh_is_not_ported(setup):
    """Scoring takes a one-process mesh of local devices (since the parallel
    slice); anything else raises."""
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import get_data_scale
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import Mesh

    config, _, model, _, _ = setup
    with pytest.raises(TypeError, match="one-process mesh"):
        get_data_scale(model, config, _port_data(config), mesh=object())
    with pytest.raises(TypeError, match="one-process mesh"):
        get_data_scale(model, config, _port_data(config),
                       mesh=Mesh(2, 1, ["cpu"], distributed=True))


@pytest.mark.parametrize("replicas,quantize", [(2, False), (3, False), (2, True)])
def test_mesh_scoring_matches_no_mesh_and_jax(setup, monkeypatch, replicas, quantize, capsys):
    """Both passes over a one-process CPU mesh of 2 or 3 replicas (batches of
    8: ragged on 3, padded by repeating the last frame, the pad rows dropped)
    give the no-mesh results and the JAX package's 8-device mesh results, in
    frame order."""
    from trustedai_cl_vae_ad_tpu.anomaly.offline import evaluate_anomalies as jax_evaluate
    from trustedai_cl_vae_ad_tpu.anomaly.offline import get_data_scale as jax_scale
    from trustedai_cl_vae_ad_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import evaluate_anomalies, get_data_scale
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import make_mesh

    config, jmodel, model, _, eval_dir = setup
    if quantize:
        monkeypatch.setenv("TCVAE_QUANT_MIN_ELEMS", "0")
    mesh = make_mesh(devices=["cpu"] * replicas)
    assert mesh.shape == {"data": replicas, "model": 1} and not mesh.distributed
    ref = get_data_scale(model, config, _port_data(config), quantize=quantize)
    got = get_data_scale(model, config, _port_data(config), mesh=mesh, quantize=quantize)
    assert ("padding ragged batch 8 -> 9" in capsys.readouterr().out) == (replicas == 3)
    want = jax_scale(jmodel, config, _jax_data(config), mesh=jax_make_mesh(), quantize=quantize)
    eps_tol = (Q_TOL * (2 * PIXELS + PIXELS * Q_TOL) if quantize
               else 1e-5 * float(np.max(_eps(want))))
    assert got["z_scores"].shape == (N_TRAIN,)
    _assert_scale_close(got, ref, 1e-5 * float(np.max(_eps(ref))))
    _assert_scale_close(got, want, eps_tol)
    res_ref = evaluate_anomalies(model, config, _port_data(config, eval_dir), ref, 3.0)
    res = evaluate_anomalies(model, config, _port_data(config, eval_dir), ref, 3.0, mesh=mesh,
                             quantize=quantize)
    res_jax = jax_evaluate(jmodel, config, _jax_data(config, eval_dir), ref, 3.0,
                           mesh=jax_make_mesh(), quantize=quantize)
    assert res["z_scores"].shape == res["norm_errs"].shape[:1] == (N_EVAL,)
    if not quantize:
        np.testing.assert_allclose(res["z_scores"], res_ref["z_scores"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["norm_errs"], res_ref["norm_errs"], rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(res["z_scores"], res_jax["z_scores"], rtol=0,
                               atol=eps_tol / ref["sigma"])
    np.testing.assert_array_equal(res["anomalies"], res_jax["anomalies"])


# -- the CLI -----------------------------------------------------------------------------------

def _csv_rows(out):
    with open(os.path.join(out, "anomaly_list.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["orig_filepath", "z_score"]
    return {os.path.basename(r[0]): float(r[1]) for r in rows[1:]}


@pytest.fixture(scope="module")
def logdirs(setup, tmp_path_factory):
    """The same weights saved as a JAX log directory and as the port's."""
    from trustedai_cl_vae_ad_tpu.config import save_config as jax_save_config
    from trustedai_cl_vae_ad_tpu_torch.config import save_config

    config, jmodel, tmodel, _, _ = setup
    root = tmp_path_factory.mktemp("logdirs")
    jdir, tdir = root / "jax", root / "port"
    jdir.mkdir()
    tdir.mkdir()
    jmodel.save_model(str(jdir), include_optimizer=False)
    jax_save_config(config, str(jdir / "config.yml"))
    tmodel.save_model(str(tdir), include_optimizer=False)
    save_config(config, str(tdir / "config.yml"))
    return str(jdir), str(tdir)


def test_cli_matches_do_anomaly_detection(setup, logdirs, tmp_path, monkeypatch):
    """The whole slice: both CLIs on the same weights and datasets write the
    same artifact files, the same originals, and z-scores within the
    tolerance above."""
    import do_anomaly_detection
    import do_anomaly_detection_torch

    _, _, _, train_dir, eval_dir = setup
    jdir, tdir = logdirs
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    monkeypatch.setattr(sys, "argv", ["do_anomaly_detection.py", "-m", jdir, "-d", eval_dir,
                                      "-o", jout, "--no-parallel"])
    do_anomaly_detection.main()
    scale, _ = do_anomaly_detection_torch.main(["-m", tdir, "-d", eval_dir, "-o", tout,
                                                "--device", "cpu"])
    want, got = _csv_rows(jout), _csv_rows(tout)
    assert got.keys() == want.keys() and len(got) == N_EVAL
    z_tol = 1e-5 * float(np.max(_eps(scale))) / scale["sigma"]
    for name in got:
        assert abs(got[name] - want[name]) <= z_tol, name
    for sub in ("err", "heatmap", "overlay", "rec", "orig"):
        assert sorted(os.listdir(os.path.join(tout, sub))) == sorted(
            os.listdir(os.path.join(jout, sub))), sub
    for name in os.listdir(os.path.join(tout, "orig")):
        with open(os.path.join(tout, "orig", name), "rb") as a, \
                open(os.path.join(jout, "orig", name), "rb") as b:
            assert a.read() == b.read(), name
    assert os.path.exists(os.path.join(tout, "anomaly_fig.png"))


def test_cli_quantize_histogram_only_boots_from_the_int8_sidecar(setup, logdirs, tmp_path,
                                                                  monkeypatch, capsys):
    """--quantize with a quantized/ sidecar boots from it (no float weights
    read) and shares that tree between the passes; without one it quantizes
    once. Both score like the in-process w8a8 passes; --histogram-only
    writes the histogram alone."""
    import shutil

    import do_anomaly_detection_torch
    from trustedai_cl_vae_ad_tpu_torch import registry
    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import get_data_scale
    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    config, _, model, _, eval_dir = setup
    tdir = str(tmp_path / "logdir")
    shutil.copytree(logdirs[1], tdir, symlinks=True)
    monkeypatch.setenv("TCVAE_QUANT_MIN_ELEMS", "0")
    want = get_data_scale(model, config, _port_data(config), quantize=True)
    capsys.readouterr()
    out = str(tmp_path / "out_quantize")
    scale, _ = do_anomaly_detection_torch.main(["-m", tdir, "-d", eval_dir, "-o", out,
                                                "--quantize", "--histogram-only",
                                                "--device", "cpu"])
    assert "no quantized checkpoint" in capsys.readouterr().out
    np.testing.assert_allclose(_eps(scale), _eps(want), rtol=1e-6)
    assert os.listdir(out) == ["anomaly_fig.png"]

    quant.save_quantized_checkpoint(tdir, quant.quantize_params(model.core, model.params))
    calls = []
    monkeypatch.setattr(quant, "quantize_params", lambda *a, **k: calls.append(a))

    def no_float_load(*a, **k):
        raise AssertionError("the float checkpoint was read")

    monkeypatch.setattr(registry, "load_model_from_directory", no_float_load)
    scale_boot, _ = do_anomaly_detection_torch.main(
        ["-m", tdir, "-d", eval_dir, "-o", str(tmp_path / "out_boot"), "--quantize",
         "--histogram-only", "--device", "cpu"])
    assert "int8 boot" in capsys.readouterr().out and calls == []
    np.testing.assert_allclose(_eps(scale_boot), _eps(want), rtol=1e-6)


def test_cli_defaults_to_the_card(setup, logdirs, tmp_path, capsys):
    import do_anomaly_detection_torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(SystemExit):
        do_anomaly_detection_torch.main(["-m", logdirs[1], "-d", setup[4], "-o",
                                         str(tmp_path / "o")])
    assert "no CUDA device" in capsys.readouterr().err
