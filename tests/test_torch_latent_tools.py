"""The port's latent tools (``output_reconstructions_torch.py``,
``interpolate_torch.py``, ``sample_latent_space_torch.py``,
``plot_j_diagram_torch.py``, ``similarity_analysis_torch.py``,
``plot_umap_torch.py``) and their math (``viz/latent.py``) against the JAX
package's tools: the latent-tool cases of ``tests/test_cli_tools.py`` and the
tools' part of ``tests/test_integration.py``, each run on both packages with
the same weights (through ``bridge.py``) and the same data, on the CPU at a
tiny config.

Tolerances: a float32 forward of the two libraries agrees at rtol 1e-5, so
the reconstruction-error JSONs are compared at rtol 1e-5; originals are the
same PNG pixels, reconstructions within 1 grey level and heatmaps within 2
(a rounding at .5 can move a level, and the JET map steps several levels per
input level); the error PNGs within 1. Decodes (interpolation, sample,
J-diagram) at atol 1e-5 on [0, 1] values. ``distances.json`` has the same
keys in the same order and values at rtol 1e-5 / atol 1e-6 (float32
z-scores from two libraries' moments); the per-latent mean, std and
kurtosis at rtol 1e-5 (atol 1e-6 for means near 0). ``PCAEmbedder`` against
``sklearn.decomposition.PCA(svd_solver="full")`` on the same data in float64:
components and ``transform`` up to each component's sign at atol 1e-5,
``inverse_transform`` at 1e-5; the JAX tool's embedding (scikit-learn's
float32 SVD) at atol 1e-4, and its decoded grid at atol 1e-4."""

import copy
import json
import os
import shutil
import subprocess
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

import interpolate_torch
import output_reconstructions_torch
import plot_j_diagram_torch
import plot_umap_torch
import sample_latent_space_torch
import similarity_analysis_torch
from tests.torch_port_helpers import paired_models
from trustedai_cl_vae_ad_tpu_torch.viz import latent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {
    "data": {"dataset": "synthetic", "image_size": [16, 16, 3], "n_train": 16, "n_val": 8},
    "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-4, "w_mse": 1.0,
             "w_skew": 0.0, "w_z_l1_reg": 0.0},
    "model": {"type": "KurtosisSingle", "decoder_dense_filters": 4, "latent_dimensions": 8,
              "layers": [4]},
    "training": {"batch_size": 8, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1},
}
CPU = ["--device", "cpu"]


def _jax_main(module_name, argv):
    """The JAX tool ``module_name``'s main() with ``argv``, as tests/test_cli_tools.py runs it."""
    import importlib

    mod = importlib.import_module(module_name)
    with mock.patch.object(sys, "argv", [module_name + ".py"] + list(argv)):
        return mod.main()


def _pngs(directory):
    return sorted(f for f in os.listdir(directory) if f.endswith(".png"))


def _png(path):
    with Image.open(path) as img:
        return np.asarray(img).astype(int)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The same seeded weights saved as a JAX and as a port log directory
    (config: synthetic data), a saved VeRi dataset, and attribute images."""
    from trustedai_cl_vae_ad_tpu.config import save_config as jax_save_config
    from trustedai_cl_vae_ad_tpu.data.builders.veri import build_veri_dataset
    from trustedai_cl_vae_ad_tpu_torch.config import save_config

    root = tmp_path_factory.mktemp("latent_tools")
    jmodel, tmodel = paired_models(copy.deepcopy(CONFIG), compile=False)
    jax_dir, port_dir = str(root / "jax_run"), str(root / "port_run")
    jmodel.save_model(jax_dir)
    jax_save_config(copy.deepcopy(CONFIG), os.path.join(jax_dir, "config.yml"))
    tmodel.save_model(port_dir, include_optimizer=False)
    save_config(copy.deepcopy(CONFIG), os.path.join(port_dir, "config.yml"))

    rng = np.random.RandomState(0)
    img_dir = root / "imgs"
    img_dir.mkdir()
    imgs = []
    for i in range(6):
        imgs.append(str(img_dir / f"img_{i}.png"))
        Image.fromarray(rng.randint(0, 255, (20, 24, 3), np.uint8)).save(imgs[-1])
    mixed = []
    for i, hw in enumerate(((20, 24), (32, 16), (12, 40))):
        mixed.append(str(root / f"mix_{i}.png"))
        Image.fromarray(rng.randint(0, 255, (*hw, 3), np.uint8)).save(mixed[-1])
    dataset = str(root / "saved_ds")
    build_veri_dataset(str(img_dir), str(img_dir), dataset, image_size=(16, 16), batch_size=4)
    return {"root": root, "jmodel": jmodel, "tmodel": tmodel, "jax_dir": jax_dir,
            "port_dir": port_dir, "imgs": imgs, "mixed": mixed, "dataset": dataset}


# -- the math -----------------------------------------------------------------------------

def _latents(seed=0, n=40, d=16):
    z = np.random.RandomState(seed).randn(n, d).astype(np.float32) * 1.5 + 0.3
    z[7] = z[8] + 1e-6         # near-duplicates keep their small distance
    return z


@pytest.mark.parametrize("metric", latent.METRICS)
def test_pairwise_distances_match_sklearn(metric):
    from sklearn.metrics import pairwise_distances

    z = _latents()
    z[3] = 0.0  # a zero row: cosine distance 1 to every other row
    got = latent.pairwise_distances(torch.from_numpy(z), metric=metric).numpy()
    want = pairwise_distances(z, metric=metric)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(np.diag(got) == 0.0)
    if metric == "cosine":
        assert np.all(got[3, np.arange(len(z)) != 3] == 1.0)
        assert got.min() >= 0.0 and got.max() <= 2.0
    else:
        assert 0 < got[7, 8] < 1e-5


def test_pairwise_distances_refuse_other_metrics():
    with pytest.raises(ValueError, match="metric"):
        latent.pairwise_distances(torch.zeros(2, 2), metric="manhattan")


def test_latent_moments_and_standardize_match_the_tools_numpy():
    """The JAX tools' numpy: np.mean, np.std, kurtosis E[((z - mean) / std)^4]
    with 0 where std is 0; z-scores with a std of 0 replaced by 1."""
    z = _latents()
    z[:, 5] = 2.0  # a constant column: std 0
    mean, std, kurt = (t.numpy() for t in latent.latent_moments(torch.from_numpy(z)))
    np.testing.assert_allclose(mean, z.mean(axis=0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std, z.std(axis=0), rtol=1e-5, atol=1e-6)
    want_kurt = np.array([np.mean(((c - c.mean()) / (c.std() if c.std() > 0 else 1.0)) ** 4)
                          for c in z.T])
    np.testing.assert_allclose(kurt, want_kurt, rtol=1e-5, atol=1e-6)
    assert std[5] == 0.0 and kurt[5] == 0.0
    scores, _mean, std_safe = latent.standardize(torch.from_numpy(z))
    safe = np.where(z.std(axis=0) == 0, 1.0, z.std(axis=0))
    np.testing.assert_allclose(std_safe.numpy(), safe, rtol=1e-5)
    np.testing.assert_allclose(scores.numpy(), (z - z.mean(axis=0)) / safe, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(16, 8), (40, 16), (30, 60)], ids=["16x8", "40x16", "30x60"])
def test_pca_embedder_matches_sklearn_full(shape):
    from sklearn.decomposition import PCA

    z = np.random.RandomState(1).randn(*shape).astype(np.float32) * np.linspace(
        0.5, 3.0, shape[1]).astype(np.float32)
    # scikit-learn in float64, as the embedder computes (its float32 SVD is off by 1e-5 of
    # the largest projection)
    ref = PCA(n_components=2, svd_solver="full").fit(z.astype(np.float64))
    emb = latent.PCAEmbedder(device="cpu").fit(z)
    signs = np.sign(np.sum(emb.components_ * ref.components_, axis=1))
    assert np.all(signs != 0)
    np.testing.assert_allclose(emb.components_ * signs[:, None], ref.components_, atol=1e-5)
    got = emb.transform(z)
    assert got.dtype == np.float32 and got.shape == (shape[0], 2)
    np.testing.assert_allclose(got * signs, ref.transform(z), atol=1e-5)
    e = ref.transform(z)[:7] * signs
    np.testing.assert_allclose(emb.inverse_transform(e), ref.inverse_transform(e * signs),
                               atol=1e-5)
    with pytest.raises(ValueError, match="n_components"):
        latent.PCAEmbedder(n_components=shape[1] + 1, device="cpu").fit(z)


# -- the tools against the JAX tools ------------------------------------------------------

@pytest.fixture(scope="module")
def reconstructions(env):
    """output_reconstructions.py and its port, each on its own log directory."""
    _jax_main("output_reconstructions", [env["jax_dir"]])
    port = output_reconstructions_torch.main([env["port_dir"], *CPU])
    return port


@pytest.mark.parametrize("split", ["train", "val"])
def test_output_reconstructions_matches_jax(env, reconstructions, split):
    with open(os.path.join(env["jax_dir"], f"{split}_reconstruction_error.json")) as f:
        want = json.load(f)
    with open(os.path.join(env["port_dir"], f"{split}_reconstruction_error.json")) as f:
        got = json.load(f)
    assert list(got) == list(want) and len(got) == (16 if split == "train" else 8)
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want], rtol=1e-5)
    assert got == {str(k): v for k, v in reconstructions[split == "val"].items()}
    for kind, tol in (("originals", 0), ("reconstructions", 1), ("errors", 1), ("heatmap", 2)):
        jd = os.path.join(env["jax_dir"], "imgs", kind, split)
        pd = os.path.join(env["port_dir"], "imgs", kind, split)
        assert _pngs(pd) == _pngs(jd) and _pngs(pd), kind
        assert not [f for f in os.listdir(pd) if f.endswith(".npy")]
        for name in _pngs(pd):
            gap = np.abs(_png(os.path.join(pd, name)) - _png(os.path.join(jd, name))).max()
            assert gap <= tol, (kind, name, gap)
    assert os.path.getsize(os.path.join(env["port_dir"], "reconstruction_hist.png")) > 0


def _jax_interpolation(jmodel, config, k, n):
    """interpolate.py's columns, step by step (the tool draws them and returns nothing)."""
    import jax.numpy as jnp

    from trustedai_cl_vae_ad_tpu.data.loader import iter_images, load_data

    data = load_data(config)
    x = np.concatenate([np.asarray(img) for img in iter_images(data["val"])], axis=0)[: 2 * n]
    _, z, _, _ = jmodel.call_detailed(jnp.asarray(x, jnp.float32))
    z = np.asarray(z)
    z0, z1 = z[:n], z[n:]
    z_delta = (z1 - z0) / k
    steps = [np.asarray(jmodel.decode(z0 + z_delta * t, apply_sigmoid=True)) for t in range(k)]
    return np.stack([x[:n], *steps, x[n:]])


def test_interpolate_matches_jax(env, tmp_path):
    out = tmp_path / "interp.png"
    got = interpolate_torch.example_interpolate(copy.deepcopy(CONFIG), env["tmodel"], str(out),
                                                k_sample_points=3, N=2)
    want = _jax_interpolation(env["jmodel"], copy.deepcopy(CONFIG), 3, 2)
    assert got.shape == want.shape == (5, 2, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert out.stat().st_size > 0
    cli_out = tmp_path / "cli.png"
    cols = interpolate_torch.main([env["port_dir"], "-k", "4", "-o", str(cli_out), *CPU])
    assert cols.shape == (6, 4, 16, 16, 3) and cli_out.stat().st_size > 0


def test_sample_latent_space_matches_jax(env, tmp_path, capsys):
    """One np.random.seed gives both tools the same z; the CLI keeps the two prints."""
    out = tmp_path / "latent_sample.png"
    np.random.seed(11)
    got = sample_latent_space_torch.main([env["port_dir"], "-o", str(out), "--min-z", "-0.5",
                                          "--max-z", "0.5", *CPU])
    printed = capsys.readouterr().out
    assert "Sample Size: (100, 8)" in printed and "Reconstruction Size: (100, 16, 16, 3)" in printed
    np.random.seed(11)
    z = np.random.random(size=(100, 8)) * (0.5 - -0.5) + -0.5
    want = np.asarray(env["jmodel"].decode(z.astype(np.float32), apply_sigmoid=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert out.stat().st_size > 0


@pytest.mark.parametrize("images", ["same", "mixed"])
def test_plot_j_diagram_matches_jax(env, tmp_path, images):
    """Mixed resolutions are resized one image at a time in both packages."""
    import jax.numpy as jnp

    from plot_j_diagram import load_images as jax_load_images

    paths = env["imgs"][:3] if images == "same" else env["mixed"]
    out = tmp_path / "j.png"
    got = plot_j_diagram_torch.main([env["port_dir"], *paths, "-o", str(out), "-n", "3", *CPU])
    assert out.stat().st_size > 0
    jimgs = jax_load_images(paths, CONFIG)
    pimgs = plot_j_diagram_torch.load_images(paths, CONFIG, "cpu")
    np.testing.assert_allclose(pimgs.numpy(), jimgs, atol=1e-5)
    _, z, _, _ = env["jmodel"].call_detailed(jnp.asarray(jimgs, jnp.float32))
    z = np.asarray(z)
    z0, zba, zca = z[0], z[1] - z[0], z[2] - z[0]
    t_vec = np.linspace(0.0, 1.0, 3)
    grid = np.stack([t0 * zba + t1 * zca + z0 for t0 in t_vec for t1 in t_vec]).astype(np.float32)
    want = np.asarray(env["jmodel"].decode(grid, apply_sigmoid=True))
    assert got.shape == want.shape == (9, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _keys(tree):
    """A nested dict's keys, depth first, in order."""
    return [(k, _keys(v) if isinstance(v, dict) else None) for k, v in tree.items()]


def _values(tree):
    return [x for v in tree.values()
            for x in (_values(v) if isinstance(v, dict) else [v])]


@pytest.fixture(scope="module")
def similarity(env, tmp_path_factory):
    root = tmp_path_factory.mktemp("similarity")
    _jax_main("similarity_analysis", ["-m", env["jax_dir"], "-d", env["dataset"],
                                      "-o", str(root / "jax"), "-f"])
    port = similarity_analysis_torch.main(["-m", env["port_dir"], "-d", env["dataset"],
                                           "-o", str(root / "port"), "-f", *CPU])
    return root / "jax" / "similarity", root / "port" / "similarity", port


def test_similarity_distances_match_jax(similarity):
    jax_dir, port_dir, _ = similarity
    with open(jax_dir / "distances.json") as f:
        want = json.load(f)
    with open(port_dir / "distances.json") as f:
        got = json.load(f)
    assert _keys(got) == _keys(want)
    assert sum(len(v) for v in got.values()) == 6 * 5 // 2
    np.testing.assert_allclose(_values(got), _values(want), rtol=1e-5, atol=1e-6)
    assert _pngs(port_dir) == _pngs(jax_dir)
    assert len(_pngs(port_dir)) == 1 + 8  # the summary and one histogram a latent column


def test_similarity_moments_match_jax(env, similarity):
    """The per-latent mean, std and kurtosis in the histograms' titles: kernel 3's
    plain version in the port, numpy in the JAX tool, on the same data."""
    import jax.numpy as jnp

    from trustedai_cl_vae_ad_tpu.data.loader import load_data

    _, _, port = similarity
    config = dict(copy.deepcopy(CONFIG), data=dict(CONFIG["data"], dataset_path=env["dataset"]))
    data = load_data(config)
    z = np.concatenate([np.asarray(env["jmodel"].call_detailed(jnp.asarray(b["image"]))[1])
                        for b in data["train"]], axis=0)
    np.testing.assert_allclose(port["z"], z, rtol=1e-5, atol=1e-6)
    mean, std = np.mean(z, axis=0), np.std(z, axis=0)
    kurt = [float(np.mean(((c - m) / (s if s > 0 else 1.0)) ** 4))
            for c, m, s in zip(z.T, mean, std)]
    np.testing.assert_allclose(port["mean"], mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port["std"], std, rtol=1e-5)
    np.testing.assert_allclose(port["kurtosis"], kurt, rtol=1e-5)
    assert port["filepaths"] == sorted(port["filepaths"], key=port["filepaths"].index)
    assert len(port["filepaths"]) == 6


def test_similarity_without_file_paths_names_items(env, tmp_path):
    """Batches without a 'filepath' get item_%06d identifiers, as in the JAX tool."""
    data = {"train": [torch.rand(4, 16, 16, 3), torch.rand(3, 16, 16, 3)]}
    out = similarity_analysis_torch.similarity_analysis(env["tmodel"], CONFIG, data,
                                                        str(tmp_path))
    assert out["filepaths"] == [f"item_{i:06d}" for i in range(7)]
    with open(tmp_path / "distances.json") as f:
        assert list(json.load(f)) == [f"item_{i:06d}" for i in range(1, 7)]


def test_similarity_force_and_output_dir_semantics(env, tmp_path):
    out = tmp_path / "o"
    args = ["-m", env["port_dir"], "-d", env["dataset"], "-o", str(out), *CPU]
    assert similarity_analysis_torch.get_args(args)[2] == str(out / "similarity")
    with pytest.raises(AssertionError, match="use --force"):
        similarity_analysis_torch.get_args(args)
    (out / "similarity" / "stale.txt").write_text("x")
    similarity_analysis_torch.get_args(args + ["-f"])
    assert os.listdir(out / "similarity") == []


def test_plot_umap_pca_matches_jax(env, tmp_path):
    """The PCA branch of both packages (scikit-learn's full solver at this size), with
    --standardize and the inverse-transform grid."""
    import jax.numpy as jnp

    import plot_umap
    from trustedai_cl_vae_ad_tpu.data.loader import load_data as jax_load_data
    from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data

    jdata, pdata = jax_load_data(copy.deepcopy(CONFIG)), load_data(copy.deepcopy(CONFIG), "cpu")
    jemb, jtrain, jval, jstats = plot_umap.plot_umap(jdata, env["jmodel"], str(tmp_path / "j.png"),
                                                     15, 0.1, standardized_flag=True)
    pemb, ptrain, pval, pstats = plot_umap_torch.plot_umap(
        pdata, env["tmodel"], str(tmp_path / "p.png"), 15, 0.1, standardized_flag=True)
    assert isinstance(pemb, latent.PCAEmbedder)
    assert ptrain.shape == (16, 2) and pval.shape == (8, 2)
    np.testing.assert_allclose(pstats["mean"], jstats["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pstats["std"], jstats["std"], rtol=1e-5)
    signs = np.sign(np.sum(pemb.components_ * jemb._pca.components_, axis=1))
    np.testing.assert_allclose(ptrain * signs, jtrain, atol=1e-4)
    np.testing.assert_allclose(pval * signs, jval, atol=1e-4)
    assert np.all(signs == 1.0)  # the same sign rule, so the same grid
    got = plot_umap_torch.plot_interpolation(env["tmodel"], pemb, ptrain, pval, pstats,
                                             str(tmp_path / "pi.png"))
    lo, hi = jtrain.min(axis=0), jtrain.max(axis=0)
    samples = np.array([[x, y] for x in np.linspace(lo[0], hi[0], 10)
                        for y in np.linspace(lo[1], hi[1], 10)], dtype=np.float32)
    z = jemb.inverse_transform(samples) * jstats["std"] + jstats["mean"]
    want = np.asarray(env["jmodel"].decode(jnp.asarray(z, jnp.float32), apply_sigmoid=True))
    assert got.shape == want.shape == (100, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert os.path.getsize(tmp_path / "pi.png") > 0 and os.path.getsize(tmp_path / "p.png") > 0


def test_plot_umap_real_umap_branch(env, monkeypatch, tmp_path):
    """The umap branch with an interface-faithful fake ``umap`` module (umap-learn
    is absent here and on the card): UMAP is built with the CLI's
    hyperparameters and driven with the JAX tool's call shapes, through the
    CLI with --standardize and --interpolate."""
    calls = {"init": None, "fit": [], "transform": [], "inverse": []}

    class FakeUMAP:
        def __init__(self, **kwargs):
            calls["init"] = kwargs
            self._dim = None

        def fit(self, z):
            z = np.asarray(z)
            self._dim = z.shape[1]
            calls["fit"].append(z.shape)
            return self

        def transform(self, z):
            z = np.asarray(z)
            assert self._dim is not None and z.shape[1:] == (self._dim,)
            calls["transform"].append(z.shape)
            return z[:, :2].astype(np.float32)

        def inverse_transform(self, e):
            e = np.asarray(e)
            calls["inverse"].append(e.shape)
            out = np.zeros((e.shape[0], self._dim), np.float32)
            out[:, :2] = e
            return out

    fake = types.ModuleType("umap")
    fake.UMAP = FakeUMAP
    monkeypatch.setitem(sys.modules, "umap", fake)
    out, interp = tmp_path / "umap.png", tmp_path / "umap_interp.png"
    emb, *_ = plot_umap_torch.main([env["port_dir"], "-o", str(out), "-n", "7", "-d", "0.25",
                                    "-m", "cosine", "--standardize", "--interpolate",
                                    "-t", str(interp), *CPU])
    assert isinstance(emb, FakeUMAP) and out.exists() and interp.exists()
    assert calls["init"] == {"n_neighbors": 7, "n_components": 2, "min_dist": 0.25,
                             "metric": "cosine", "verbose": True}
    assert calls["fit"] == [(16, 8)]
    assert calls["transform"] == [(16, 8), (8, 8)]
    assert calls["inverse"] == [(100, 2)]


def test_veri_flow_build_train_tools(tmp_path):
    """image dirs -> the port's VeRi builder -> saved dataset -> train_model ->
    the latent tools (the embedding's PCA branch and its grid, interpolate)
    against the trained model, as tests/test_integration.py runs the JAX ones."""
    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.data.builders.veri import build_veri_dataset
    from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.train.loop import train_model

    rng = np.random.RandomState(0)
    for split, n in (("train_imgs", 12), ("val_imgs", 6)):
        d = tmp_path / split
        d.mkdir()
        for i in range(n):
            Image.fromarray(rng.randint(0, 255, (30, 40, 3), np.uint8)).save(d / f"{i}.jpg")
    ds_dir = tmp_path / "veri_ds"
    build_veri_dataset(str(tmp_path / "train_imgs"), str(tmp_path / "val_imgs"), str(ds_dir),
                       image_size=(24, 24), batch_size=4)
    config = {
        "data": {"dataset_path": str(ds_dir), "train_split": "train",
                 "val_split": "validation", "image_size": [16, 16, 3]},
        "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-4,
                 "w_mse": 1.0, "w_skew": 0.0, "w_z_l1_reg": 0.0},
        "model": {"type": "KurtosisSingle", "decoder_dense_filters": 2,
                  "latent_dimensions": 4, "layers": [2]},
        "training": {"batch_size": 4, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1},
        "logdir": str(tmp_path / "run"),
    }
    os.makedirs(config["logdir"])
    save_config(config, os.path.join(config["logdir"], "config.yml"))
    model = load_model_from_config(config, device="cpu")
    data = load_data(config, device="cpu")
    model = train_model(config, model, data, parallel=False)
    assert os.path.isdir(os.path.join(config["logdir"], "encoder"))

    embedder, train_emb, val_emb, _ = plot_umap_torch.plot_umap(
        data, model, str(tmp_path / "umap.png"), n_neighbors=5, min_distance=0.1)
    assert train_emb.shape == (12, 2) and len(val_emb) == 6
    plot_umap_torch.plot_interpolation(model, embedder, train_emb, val_emb, None,
                                       str(tmp_path / "umap_interp.png"))
    assert os.path.getsize(tmp_path / "umap_interp.png") > 0
    interpolate_torch.example_interpolate(config, model, str(tmp_path / "interp.png"),
                                          k_sample_points=3, N=2)
    assert os.path.getsize(tmp_path / "interp.png") > 0


# -- the surface -------------------------------------------------------------------------

TOOL_ARGS = {
    "output_reconstructions_torch": lambda e: [e["port_dir"]],
    "interpolate_torch": lambda e: [e["port_dir"]],
    "sample_latent_space_torch": lambda e: [e["port_dir"]],
    "plot_j_diagram_torch": lambda e: [e["port_dir"], *e["imgs"][:3]],
    "plot_umap_torch": lambda e: [e["port_dir"]],
}


@pytest.mark.parametrize("tool", sorted(TOOL_ARGS))
def test_tools_default_to_the_card(env, tool, capsys):
    """--device defaults to cuda, and without a CUDA device the parser refuses:
    no tool falls back to the CPU."""
    module = sys.modules[tool]
    with pytest.raises(SystemExit):
        module.get_args(TOOL_ARGS[tool](env))
    assert "no CUDA device" in capsys.readouterr().err
    assert module.get_args(TOOL_ARGS[tool](env) + CPU).device == torch.device("cpu")


SUBPROCESS = r"""
import json, os, sys
sys.modules["matplotlib"] = None
sys.modules["sklearn"] = None
sys.path.insert(0, {repo!r})
import interpolate_torch, output_reconstructions_torch, plot_j_diagram_torch
import plot_umap_torch, sample_latent_space_torch, similarity_analysis_torch
logdir, dataset, out = {logdir!r}, {dataset!r}, {out!r}
cpu = ["--device", "cpu"]
output_reconstructions_torch.main([logdir] + cpu)
interpolate_torch.main([logdir, "-k", "3", "-o", os.path.join(out, "i.png")] + cpu)
sample_latent_space_torch.main([logdir, "-o", os.path.join(out, "s.png")] + cpu)
plot_j_diagram_torch.main([logdir, *{imgs!r}, "-o", os.path.join(out, "j.png"), "-n", "3"] + cpu)
similarity_analysis_torch.main(["-m", logdir, "-d", dataset, "-o", out, "-f"] + cpu)
plot_umap_torch.main([logdir, "-o", os.path.join(out, "u.png"), "--standardize",
                      "--interpolate", "-t", os.path.join(out, "ui.png")] + cpu)
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in ("matplotlib", "sklearn", "jax")
                        and sys.modules[k] is not None)))
"""


def test_tools_run_without_matplotlib_and_sklearn(env, tmp_path):
    """The card's machine has neither: all six tools run to their artifacts with
    both unimportable, and load neither (nor jax)."""
    logdir = str(tmp_path / "run")
    shutil.copytree(env["port_dir"], logdir, symlinks=True)
    out = str(tmp_path / "out")
    os.makedirs(out)
    code = SUBPROCESS.format(repo=REPO, logdir=logdir, dataset=env["dataset"], out=out,
                             imgs=env["mixed"])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert {"i.png", "s.png", "j.png", "u.png", "ui.png"} <= set(os.listdir(out))
    assert len(_pngs(os.path.join(out, "similarity"))) == 9
    assert os.path.isfile(os.path.join(logdir, "train_reconstruction_error.json"))
    assert len(_pngs(os.path.join(logdir, "imgs", "heatmap", "val"))) == 8
