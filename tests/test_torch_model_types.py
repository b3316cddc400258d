"""KurtosisSingleCVAE and KLGaussianCVAE of the port against the JAX cores on
the same weights (through the bridge), inputs and latent noise: every key of
the loss dict (eval and training, weighted and unweighted), d loss / d params
for every leaf, three whole training steps against the JAX wrapper, and the
checkpoint of each type. float32 on the CPU; values at rtol 1e-4 / atol 1e-6,
gradients at rtol 1e-3 with an absolute floor of 1e-4 of the leaf's largest
gradient (convolutions and sums run in another order in the two frameworks),
parameters after three Adam steps as tests/test_torch_train_step.py holds
them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    LOSS_KEYS_BY_TYPE,
    jax_core_and_params,
    loss_to_np,
    next_jax_eps,
    paired_models,
    torch_model_like,
    typed_config,
)
from trustedai_cl_vae_ad_tpu_torch.bridge import params_from_flax, params_to_flax
from trustedai_cl_vae_ad_tpu_torch.testing import compare_train_runs, train_inputs

B = 6
WEIGHTS = np.array([1.0, 0.0, 1.0, 0.5, 0.0, 1.0], np.float32)
TYPES = ["KurtosisSingle", "KLGaussian"]


@pytest.fixture(scope="module", params=TYPES)
def pair(request):
    cfg = typed_config(request.param, edf=16)
    core, params = jax_core_and_params(cfg, seed=3)
    return request.param, cfg, core, params, torch_model_like(cfg, params)


def _x(cfg, seed=0):
    w, h, c = cfg["data"]["image_size"]
    return np.random.RandomState(seed).uniform(0, 1, (B, w, h, c)).astype(np.float32)


def _eps_of(key, latent):
    return np.array(jax.random.normal(key, (B, latent), jnp.float32))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_loss_dict_matches_jax(pair, training, weighted):
    model_type, cfg, core, params, tmodel = pair
    keys = LOSS_KEYS_BY_TYPE[model_type]
    x = _x(cfg)
    key = jax.random.PRNGKey(11)
    jd, jx_hat = core.compute_loss(params, jnp.asarray(x), training=training, return_inf=True,
                                   rng=key, weights=jnp.asarray(WEIGHTS) if weighted else None)
    eps = torch.from_numpy(_eps_of(key, core.latent_size)) if training else None
    with torch.no_grad():
        td, tx_hat = tmodel.core.compute_loss(
            torch.from_numpy(x), training=training, return_inf=True, eps=eps,
            weights=torch.from_numpy(WEIGHTS) if weighted else None)
    assert list(td) == list(jd) == keys
    got, ref = loss_to_np(td), loss_to_np(jd)
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tx_hat.numpy(), np.asarray(jx_hat), rtol=1e-4, atol=1e-6)


def test_all_ones_weights_equal_the_unweighted_loss(pair):
    model_type, cfg, _core, _params, tmodel = pair
    x = torch.from_numpy(_x(cfg, seed=4))
    with torch.no_grad():
        a = tmodel.core.compute_loss(x)
        b = tmodel.core.compute_loss(x, weights=torch.ones(B))
        # weight-0 rows drop out: the masked loss is the loss of the kept rows
        c = tmodel.core.compute_loss(x, weights=torch.from_numpy((WEIGHTS > 0).astype(np.float32)))
        d = tmodel.core.compute_loss(x[torch.from_numpy(WEIGHTS > 0)])
    for k in LOSS_KEYS_BY_TYPE[model_type]:
        np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(c[k]), float(d[k]), rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_parameter_gradients_match_jax_grad(pair, weighted):
    _type, cfg, core, params, tmodel = pair
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


def test_kl_helpers_match_jax_and_are_a_divergence():
    from trustedai_cl_vae_ad_tpu.models.kl_gaussian import KLGaussianCVAE as JaxKL
    from trustedai_cl_vae_ad_tpu_torch.models.kl_gaussian import KLGaussianCVAE

    rng = np.random.RandomState(4)
    m, lv = (rng.randn(5, 8).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        KLGaussianCVAE._kl_rows(torch.from_numpy(m), torch.from_numpy(lv)).numpy(),
        np.asarray(JaxKL._kl_rows(jnp.asarray(m), jnp.asarray(lv))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(KLGaussianCVAE.kl_divergence_gaussian(torch.from_numpy(m), torch.from_numpy(lv))),
        float(JaxKL.kl_divergence_gaussian(jnp.asarray(m), jnp.asarray(lv))), rtol=1e-5)
    zero = torch.zeros(3, 8)
    assert float(KLGaussianCVAE.kl_divergence_gaussian(zero, zero)) == 0.0
    assert float(KLGaussianCVAE._kl_rows(torch.from_numpy(m), torch.from_numpy(lv)).min()) > 0


def test_kurtosis_single_uses_population_std_and_the_l1_weight_for_z_l2():
    """x_std_loss takes the population std (with a batch of 2 the sample std
    is sqrt(2) larger), and z_l2 is weighted by w_z_l1_reg, as in the JAX
    core."""
    cfg = typed_config("KurtosisSingle")
    core, params = jax_core_and_params(cfg, seed=1)
    tmodel = torch_model_like(cfg, params)
    x = _x(cfg, seed=6)[:2]
    jd = core.compute_loss(params, jnp.asarray(x))
    with torch.no_grad():
        td = tmodel.core.compute_loss(torch.from_numpy(x))
        tmodel.core.w_z_l1_reg = 0.0
        without = tmodel.core.compute_loss(torch.from_numpy(x))
    np.testing.assert_allclose(float(td["x_std_loss"]), float(jd["x_std_loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(td["loss"]) - float(without["loss"]),
                               cfg["loss"]["w_z_l1_reg"] * float(td["z_l2"]), rtol=1e-3)


def _leaves(tree):
    for part in ("encoder", "decoder"):
        for layer, leaves in tree[part].items():
            for leaf, arr in leaves.items():
                yield f"{part}/{layer}/{leaf}", np.asarray(arr)


@pytest.mark.parametrize("model_type", TYPES)
def test_three_train_steps_match_the_jax_wrapper(model_type):
    cfg = typed_config(model_type, edf=16)
    jmodel, tmodel = paired_models(cfg, seed=1)
    assert type(tmodel.core).__name__ == type(jmodel.core).__name__ == f"{model_type}CVAE"
    lr = cfg["training"]["learning_rate"]
    keys = LOSS_KEYS_BY_TYPE[model_type]
    got, ref = [], []
    for x, _ in train_inputs(cfg, n_steps=3, batch=8, seed=5):
        eps = next_jax_eps(jmodel, 8)
        jloss, jx_hat = jmodel.train_step_and_run(jnp.asarray(x))
        tloss, tx_hat = tmodel.train_step_and_run(torch.from_numpy(x), eps=torch.from_numpy(eps))
        assert list(tloss) == keys and not tx_hat.requires_grad
        ref.append(dict(loss_to_np(jloss), x_hat=np.asarray(jx_hat)))
        got.append(dict(loss_to_np(tloss), x_hat=tx_hat.numpy()))
    compare_train_runs(got, ref, rtol=1e-4, atol=1e-6, label=f"{model_type}: port vs jax")
    after_j = dict(_leaves(jax.device_get(jmodel.params)))
    after_t = dict(_leaves(params_to_flax(tmodel.params)))
    for name, ref_leaf in after_j.items():
        np.testing.assert_allclose(after_t[name], ref_leaf, rtol=0, atol=0.05 * 3 * lr,
                                   err_msg=name)
        assert (np.abs(after_t[name] - ref_leaf) <= 1e-5).mean() > 0.99, name
    # eval-mode losses agree after the steps too
    x = train_inputs(cfg, n_steps=1, batch=8, seed=9)[0][0]
    np.testing.assert_allclose(float(tmodel.test_step(x)["loss"]),
                               float(jmodel.test_step(jnp.asarray(x))["loss"]), rtol=1e-3)


@pytest.mark.parametrize("model_type", ["KurtosisGlobal"] + TYPES)
def test_bridge_and_checkpoint_carry_every_type(model_type, tmp_path):
    """The three types share one parameter tree: the bridge maps each, and a
    checkpoint of each reloads through the registry as its own class."""
    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    cfg = typed_config(model_type)
    _core, params = jax_core_and_params(cfg, seed=2)
    tree = jax.device_get(params)
    tmodel = torch_model_like(cfg, params)
    assert set(params_from_flax(tree)) == set(tmodel.params)
    back = params_to_flax(tmodel.params)
    for name, leaf in _leaves(tree):
        part, layer, key = name.split("/")
        np.testing.assert_array_equal(back[part][layer][key], leaf)
    tmodel.compile()
    x = train_inputs(cfg, n_steps=1, batch=8, seed=1)[0][0]
    tmodel.train_step(x)
    logdir = str(tmp_path / "run")
    tmodel.save_model(logdir)
    save_config(cfg, f"{logdir}/config.yml")
    for restore in (False, True):
        again, _ = load_model_from_directory(logdir, device="cpu", restore_optimizer=restore)
        assert type(again.core).__name__ == f"{model_type}CVAE"
        assert (again.optimizer is not None) == restore
        for k, v in tmodel.params.items():
            assert torch.equal(again.params[k], v)
    assert again.optimizer.count == 1
    assert list(again.test_step(x)) == LOSS_KEYS_BY_TYPE[model_type]
