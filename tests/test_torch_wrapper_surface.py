"""The rest of ``VAEModel``'s surface in the port (reparameterize, decode,
sample, call_detailed, __call__) and ``train/loop.py::evaluate``, held
against the JAX package on the CPU at a tiny config with the same weights
(through ``bridge.py``) and, where the JAX side draws a latent eps, the same
eps. Forwards agree at rtol 1e-5 / atol 1e-6 (float32, the two libraries'
convolutions sum in other orders)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import paired_models, tiny_config, to_np

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def pair():
    config = tiny_config(image=(16, 16, 3), layers=(4,), latent=4)
    jmodel, tmodel = paired_models(config, compile=False)
    x = np.random.RandomState(0).rand(5, 16, 16, 3).astype(np.float32)
    return config, jmodel, tmodel, x


def _fixed_rng(jmodel, monkeypatch, seed=7):
    """Pin the JAX model's next draws to one key; returns that key."""
    key = jax.random.PRNGKey(seed)
    monkeypatch.setattr(jmodel, "_next_rng", lambda: key)
    return key


def _close(got, want):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_reparameterize_eval_is_deterministic(pair):
    _, jmodel, tmodel, x = pair
    mean, logvar = jmodel.encode(jnp.asarray(x))
    want = jmodel.reparameterize(mean, logvar)
    got = tmodel.reparameterize(np.array(mean), np.array(logvar))
    _close(got, want)
    np.testing.assert_array_equal(to_np(got), to_np(tmodel.reparameterize(
        np.array(mean), np.array(logvar))))


def test_reparameterize_training_with_the_same_eps(pair, monkeypatch):
    _, jmodel, tmodel, x = pair
    mean, logvar = jmodel.encode(jnp.asarray(x))
    key = _fixed_rng(jmodel, monkeypatch)
    eps = np.array(jax.random.normal(key, mean.shape, mean.dtype))
    want = jmodel.reparameterize(mean, logvar, training=True)
    got = tmodel.reparameterize(np.array(mean), np.array(logvar), training=True, eps=eps)
    _close(got, want)


def test_reparameterize_training_draws_from_the_models_generator(pair):
    """Without eps, training mode draws N(0, 1) from the model's generator:
    seeded, so a reseeded model draws the same eps again."""
    _, _, tmodel, _ = pair
    mean, logvar = torch.zeros(64, 4), torch.zeros(64, 4)
    tmodel.generator.manual_seed(3)
    first = tmodel.reparameterize(mean, logvar, training=True)
    tmodel.generator.manual_seed(3)
    again = tmodel.reparameterize(mean, logvar, training=True)
    assert torch.equal(first, again)
    assert 0.5 < float(first.std()) < 1.5 and not torch.equal(first, torch.zeros_like(first))


@pytest.mark.parametrize("apply_sigmoid", [False, True])
def test_decode_matches_jax(pair, apply_sigmoid):
    _, jmodel, tmodel, _ = pair
    z = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    _close(tmodel.decode(z, apply_sigmoid=apply_sigmoid),
           jmodel.decode(z, apply_sigmoid=apply_sigmoid))


def test_sample_matches_jax_given_eps(pair):
    _, jmodel, tmodel, _ = pair
    eps = np.random.RandomState(2).randn(6, 4).astype(np.float32)
    got = tmodel.sample(eps)
    _close(got, jmodel.sample(eps))
    assert got.shape == (6, 16, 16, 3) and float(got.min()) >= 0 and float(got.max()) <= 1


def test_sample_draws_n_latents(pair):
    _, jmodel, tmodel, _ = pair
    assert tuple(tmodel.sample(n=7).shape) == tuple(jmodel.sample(n=7).shape) == (7, 16, 16, 3)


@pytest.mark.parametrize("training", [False, True])
def test_call_detailed_matches_jax(pair, monkeypatch, training):
    """(x_prob, z, mean, logvar) in the JAX order; in training mode both
    packages add the same eps to the latent (the encoder input is not
    fuzzed in either)."""
    _, jmodel, tmodel, x = pair
    key = _fixed_rng(jmodel, monkeypatch)
    eps = np.array(jax.random.normal(key, (x.shape[0], 4), jnp.float32)) if training else None
    want = jmodel.call_detailed(jnp.asarray(x), training=training)
    got = tmodel.call_detailed(x, training=training, eps=eps)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w)


def test_dunder_call_is_call(pair, monkeypatch):
    _, jmodel, tmodel, x = pair
    _close(tmodel(x), jmodel(jnp.asarray(x)))
    assert torch.equal(tmodel(x), tmodel.call(x))
    u8 = (x * 255).astype(np.uint8)  # the uint8 contract: raw pixels normalize on the device
    assert torch.equal(tmodel(u8), tmodel.call(torch.from_numpy(u8).float() / 255.0))
    key = _fixed_rng(jmodel, monkeypatch)
    eps = np.array(jax.random.normal(key, (x.shape[0], 4), jnp.float32))
    _close(tmodel(x, training=True, eps=eps), jmodel(jnp.asarray(x), training=True))


# -- evaluate ------------------------------------------------------------------------------

def _capture_figures(monkeypatch, module):
    """Replace a plots module's image_grid and histogram by recorders."""
    calls = []
    monkeypatch.setattr(module, "image_grid",
                        lambda images, path, title, cols=5: calls.append(
                            ("grid", os.path.basename(path), title, np.asarray(images))))
    monkeypatch.setattr(module, "histogram",
                        lambda path, series, title, **kw: calls.append(
                            ("hist", os.path.basename(path), title,
                             {k: np.asarray(v) for k, v in series.items()}, kw)))
    return calls


def _evaluate_both(pair, monkeypatch, tmp_path, data):
    from trustedai_cl_vae_ad_tpu.train.loop import evaluate as jax_evaluate
    from trustedai_cl_vae_ad_tpu.viz import plots as jplots
    from trustedai_cl_vae_ad_tpu_torch.train.loop import evaluate
    from trustedai_cl_vae_ad_tpu_torch.viz import plots

    config, jmodel, tmodel, _ = pair
    config = dict(config, logdir=str(tmp_path))
    want = _capture_figures(monkeypatch, jplots)
    got = _capture_figures(monkeypatch, plots)
    jax_evaluate(config, jmodel, data, n=4)
    evaluate(config, tmodel, data, n=4)
    return got, want


def _assert_same_figures(got, want):
    assert [c[:3] for c in got] == [c[:3] for c in want] == [
        ("grid", "original.png", "Original"), ("grid", "reconstruction.png", "Reconstruction"),
        ("hist", "output_histogram.png", "Flat Image Histogram"),
        ("hist", "latent_histogram.png", "Latent Vector Histogram")]
    for g, w in zip(got, want):
        if g[0] == "grid":
            # min-max scaling divides by the batch's range: float32 steps of that size
            np.testing.assert_allclose(g[3], w[3], rtol=RTOL, atol=1e-5)
        else:
            assert g[3].keys() == w[3].keys() and g[4] == w[4] == {"bins": 64}
            for k in g[3]:
                np.testing.assert_allclose(g[3][k], w[3][k], rtol=RTOL, atol=1e-5)


def test_evaluate_figures_match_jax(pair, monkeypatch, tmp_path):
    """The arrays behind the four figures equal the JAX package's: the first
    n validation frames, their min-max scaled reconstruction, and the latent
    means; the batches straddle n."""
    x = pair[3]
    got, want = _evaluate_both(pair, monkeypatch, tmp_path, {"train": None,
                                                            "val": [x[:3], x[3:]]})
    _assert_same_figures(got, want)
    assert got[0][3].shape == (4, 16, 16, 3) and got[3][3]["latent"].shape == (4, 4)


def test_evaluate_keeps_the_uint8_contract(pair, monkeypatch, tmp_path):
    """uint8 frames are raw pixels: normalized before the model and the
    figures, as in the JAX package; the training split serves when there is
    no validation split."""
    u8 = (pair[3] * 255).astype(np.uint8)
    got, want = _evaluate_both(pair, monkeypatch, tmp_path, {"train": [u8], "val": None})
    _assert_same_figures(got, want)
    np.testing.assert_allclose(got[0][3], u8[:4].astype(np.float32) / 255.0, rtol=1e-6)


def test_evaluate_writes_the_four_figures(pair, tmp_path):
    from trustedai_cl_vae_ad_tpu_torch.train.loop import evaluate

    config, _, tmodel, x = pair
    evaluate(dict(config, logdir=str(tmp_path)), tmodel, {"val": [torch.from_numpy(x)]}, n=3)
    for name in ("original.png", "reconstruction.png", "output_histogram.png",
                 "latent_histogram.png"):
        assert (tmp_path / name).stat().st_size > 0, name
    evaluate(dict(config, logdir=str(tmp_path / "none")), tmodel, {"val": []})  # no data: a note
    assert not (tmp_path / "none").exists()
