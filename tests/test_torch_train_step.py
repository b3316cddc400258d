"""Whole training steps of the port against the JAX package, float32 on the
CPU, from the same weights, batches and latent noise.

Tolerances: loss dicts and x_hat at rtol 1e-4 / atol 1e-6 (convolutions and
sums in another order). Parameters after three Adam steps at atol 5% of what
the steps can move them (3 * lr): Adam divides each gradient by its own
magnitude, so an entry whose gradient is rounding noise (|g| near eps = 1e-8)
can step differently in the two frameworks, while every entry with a real
gradient moves by the same +-lr."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import LOSS_KEYS, loss_to_np, next_jax_eps, paired_models, tiny_config
from trustedai_cl_vae_ad_tpu_torch.bridge import (
    opt_state_from_optax,
    opt_state_to_optax,
    params_to_flax,
)
from trustedai_cl_vae_ad_tpu_torch.testing import compare_train_runs, train_inputs

B = 8


def _leaves(tree):
    for part in ("encoder", "decoder"):
        for layer, leaves in tree[part].items():
            for leaf, arr in leaves.items():
                yield f"{part}/{layer}/{leaf}", np.asarray(arr)


def test_three_train_steps_match_jax():
    cfg = tiny_config(edf=16)
    cfg["loss"].update(w_kurtosis=1e-2, w_skew=5e-3, w_z_l1_reg=1e-3)
    jmodel, tmodel = paired_models(cfg, seed=1)
    lr = cfg["training"]["learning_rate"]
    start = dict(_leaves(jax.device_get(jmodel.params)))
    got, ref = [], []
    for x, _ in train_inputs(cfg, n_steps=3, batch=B, seed=5):
        eps = next_jax_eps(jmodel, B)
        jloss, jx_hat = jmodel.train_step_and_run(jnp.asarray(x))
        tloss, tx_hat = tmodel.train_step_and_run(torch.from_numpy(x), eps=torch.from_numpy(eps))
        assert list(tloss) == LOSS_KEYS and not tx_hat.requires_grad
        ref.append(dict(loss_to_np(jloss), x_hat=np.asarray(jx_hat)))
        got.append(dict(loss_to_np(tloss), x_hat=tx_hat.numpy()))
    compare_train_runs(got, ref, rtol=1e-4, atol=1e-6, label="port vs jax")
    after_j = dict(_leaves(jax.device_get(jmodel.params)))
    after_t = dict(_leaves(params_to_flax(tmodel.params)))
    assert set(after_j) == set(after_t)
    moved = 0.0
    for name, ref_leaf in after_j.items():
        np.testing.assert_allclose(after_t[name], ref_leaf, rtol=0, atol=0.05 * 3 * lr,
                                   err_msg=name)
        # nearly all entries agree far more closely than the bound
        close = np.abs(after_t[name] - ref_leaf) <= 1e-5
        assert close.mean() > 0.99, (name, close.mean())
        moved = max(moved, float(np.abs(ref_leaf - start[name]).max()))
    assert moved > 2 * lr  # three steps of about lr each
    # Adam state crosses the bridge both ways
    inner = jax.device_get(jmodel.opt_state.inner_state[0])
    state = opt_state_from_optax(inner.count, inner.mu, inner.nu)
    assert state["count"] == tmodel.optimizer.count == 3
    count, mu_tree, nu_tree = opt_state_to_optax(tmodel.optimizer.state_dict())
    assert count == 3
    ref_nu = dict(_leaves(inner.nu))
    for name, a in _leaves(nu_tree):
        np.testing.assert_allclose(a, ref_nu[name], rtol=1e-3, atol=1e-12, err_msg=name)
    tmodel.optimizer.load_state_dict(state)  # shapes and names fit
    assert tmodel.optimizer.count == 3


def test_train_step_draws_its_own_eps_and_needs_compile():
    cfg = tiny_config()
    _jmodel, tmodel = paired_models(cfg, seed=2, compile=False)
    x = train_inputs(cfg, n_steps=1, batch=4)[0][0]
    with pytest.raises(RuntimeError, match="compile"):
        tmodel.train_step(x)
    with pytest.raises(RuntimeError, match="compile"):
        tmodel.set_learning_rate(1e-4)
    with pytest.raises(TypeError, match="Mesh"):
        tmodel.compile(mesh=object())
    tmodel.compile(learning_rate=5e-4)
    assert tmodel.learning_rate == 5e-4
    tmodel.set_learning_rate(2e-4)
    assert tmodel.learning_rate == 2e-4 and tmodel.optimizer.name == "adam"
    before = {k: v.clone() for k, v in tmodel.params.items()}
    a = tmodel.train_step(x)            # eps from the model's seeded generator
    assert all(np.isfinite(float(v)) for v in a.values())
    assert any(not torch.equal(before[k], v) for k, v in tmodel.params.items())
    # eval-mode losses take no noise: the same twice, and no gradient state
    l1, l2 = tmodel.test_step(x), tmodel.compute_loss(x)
    assert all(float(l1[k]) == float(l2[k]) for k in l1)
    assert all(p.grad is None for p in tmodel.core.parameters())
    # beta is the core's input-noise stddev, mutable at run time
    tmodel.beta = 0.25
    assert tmodel.beta == tmodel.core.beta == 0.25
    m0, _ = tmodel.encode(x)
    m1, _ = tmodel.encode(x, training=True)
    assert not torch.equal(m0, m1)


def test_train_score_step_matches_bench_step(monkeypatch):
    """``train_score_step`` against the step that the JAX package's bench.py
    times (``build_bench_step``), on a tiny float32 core with ``adam_lean``."""
    # bench.py sets these with setdefault when it is imported
    monkeypatch.setenv("TCVAE_COMPILER_OPTIONS", "")
    monkeypatch.setenv("TCVAE_COMPILE_CACHE", "")
    import bench

    from trustedai_cl_vae_ad_tpu.ops.adam import adam_lean
    from trustedai_cl_vae_ad_tpu_torch.train.bench_step import flagship_config, train_score_step

    assert flagship_config() == bench._flagship_config()
    cfg = tiny_config()
    cfg["training"].update(optimizer="adam_lean", learning_rate=1e-4)
    jmodel, tmodel = paired_models(cfg, seed=3, compile=False)
    tmodel.compile()
    optimizer = adam_lean(1e-4)
    params = jax.tree.map(jnp.array, jmodel.params)
    opt_state = optimizer.init(params)
    step = bench.build_bench_step(jmodel.core, optimizer)
    rng = np.random.RandomState(0)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    mu, sigma = 100.0, 10.0
    for key in keys:
        x8 = rng.randint(0, 256, (B, 32, 48, 3), dtype=np.uint8)
        eps = np.array(jax.random.normal(key, (B, jmodel.latent_size), jnp.float32))
        params, opt_state, jloss, jz = step(params, opt_state, jnp.asarray(x8), key,
                                            jnp.float32(mu), jnp.float32(sigma))
        tloss, tz = train_score_step(tmodel, torch.from_numpy(x8), mu, sigma,
                                     eps=torch.from_numpy(eps))
        assert tz.shape == (B,) and not tz.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-4)
