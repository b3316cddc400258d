"""KurtosisGlobalCVAE.compute_loss of the port against the JAX core on the
same weights (through the bridge), inputs and latent noise: all 12 keys, and
d loss / d params for every leaf. float32 on the CPU; values at rtol 1e-4 /
atol 1e-6 and gradients at rtol 1e-3 / atol 1e-7 (convolutions and sums run
in another order in the two frameworks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    LOSS_KEYS,
    jax_core_and_params,
    loss_to_np,
    tiny_config,
    torch_model_like,
)
from trustedai_cl_vae_ad_tpu_torch.bridge import params_to_flax

B = 6
WEIGHTS = np.array([1.0, 0.0, 1.0, 0.5, 0.0, 1.0], np.float32)


def _config():
    cfg = tiny_config(edf=16)
    # every optimized term and every weighted statistic takes part
    cfg["loss"].update(w_kurtosis=1e-2, w_skew=5e-3, w_z_l1_reg=1e-3)
    return cfg


@pytest.fixture(scope="module")
def pair():
    cfg = _config()
    core, params = jax_core_and_params(cfg, seed=3)
    return cfg, core, params, torch_model_like(cfg, params)


def _x(cfg, seed=0):
    w, h, c = cfg["data"]["image_size"]
    return np.random.RandomState(seed).uniform(0, 1, (B, w, h, c)).astype(np.float32)


def _eps_of(key, latent):
    return np.array(jax.random.normal(key, (B, latent), jnp.float32))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_loss_dict_matches_jax(pair, training, weighted):
    cfg, core, params, tmodel = pair
    x = _x(cfg)
    key = jax.random.PRNGKey(11)
    weights = WEIGHTS if weighted else None
    jd, jx_hat = core.compute_loss(params, jnp.asarray(x), training=training, return_inf=True,
                                   rng=key, weights=None if weights is None else jnp.asarray(weights))
    eps = torch.from_numpy(_eps_of(key, core.latent_size)) if training else None
    with torch.no_grad():
        td, tx_hat = tmodel.core.compute_loss(
            torch.from_numpy(x), training=training, return_inf=True, eps=eps,
            weights=None if weights is None else torch.from_numpy(weights))
    assert list(td) == list(jd) == LOSS_KEYS
    got, ref = loss_to_np(td), loss_to_np(jd)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tx_hat.numpy(), np.asarray(jx_hat), rtol=1e-4, atol=1e-6)


def test_uint8_input_is_normalized_on_the_way_in(pair):
    cfg, _core, _params, tmodel = pair
    x8 = (np.random.RandomState(1).uniform(0, 256, _x(cfg).shape)).astype(np.uint8)
    with torch.no_grad():
        a = tmodel.core.compute_loss(torch.from_numpy(x8))
        b = tmodel.core.compute_loss(torch.from_numpy(x8.astype(np.float32) / 255.0))
    for k in LOSS_KEYS:
        assert float(a[k]) == float(b[k]), k


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_parameter_gradients_match_jax_grad(pair, weighted):
    cfg, core, params, tmodel = pair
    x = _x(cfg, seed=2)
    key = jax.random.PRNGKey(5)
    jw = jnp.asarray(WEIGHTS) if weighted else None

    def loss_fn(p):
        return core.compute_loss(p, jnp.asarray(x), training=True, rng=key, weights=jw)["loss"]

    jgrads = jax.device_get(jax.grad(loss_fn)(params))
    named = dict(tmodel.core.named_parameters())
    loss = tmodel.core.compute_loss(
        torch.from_numpy(x), training=True, eps=torch.from_numpy(_eps_of(key, core.latent_size)),
        weights=torch.from_numpy(WEIGHTS) if weighted else None)["loss"]
    tgrads = torch.autograd.grad(loss, list(named.values()))
    tree = params_to_flax(dict(zip(named, tgrads)))
    n_leaves = 0
    for part in ("encoder", "decoder"):
        assert set(tree[part]) == set(jgrads[part])
        for layer, leaves in jgrads[part].items():
            for leaf, ref in leaves.items():
                got = tree[part][layer][leaf]
                scale = float(np.max(np.abs(ref)))
                assert scale > 0, f"{part}/{layer}/{leaf}: the reference gradient is all zero"
                np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * scale,
                                           err_msg=f"{part}/{layer}/{leaf}")
                n_leaves += 1
    assert n_leaves == len(named) == 16


def test_legacy_helpers_match_jax(pair):
    _cfg, core, _params, tmodel = pair
    rng = np.random.RandomState(4)
    s, m, lv = (rng.randn(5, 8).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        tmodel.core.log_normal_pdf(*(torch.from_numpy(a) for a in (s, m, lv))).numpy(),
        np.asarray(core.log_normal_pdf(jnp.asarray(s), jnp.asarray(m), jnp.asarray(lv))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(tmodel.core.kl_divergence_gaussian(torch.from_numpy(m), torch.from_numpy(lv))),
        float(core.kl_divergence_gaussian(jnp.asarray(m), jnp.asarray(lv))), rtol=1e-5)


def test_population_std_not_sample_std(pair):
    """x_std_loss uses the population standard deviation (correction 0), as
    jnp.std does; with a batch of 2 the sample std would be sqrt(2) larger."""
    cfg, core, params, tmodel = pair
    x = _x(cfg, seed=6)[:2]
    jd = core.compute_loss(params, jnp.asarray(x))
    with torch.no_grad():
        td = tmodel.core.compute_loss(torch.from_numpy(x))
    np.testing.assert_allclose(float(td["x_std_loss"]), float(jd["x_std_loss"]), rtol=1e-4)
