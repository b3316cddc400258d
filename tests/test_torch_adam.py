"""The port's Adam (``adam``, ``adam_lean``) against optax as the JAX wrapper
builds it (``make_optimizer``), over 5 steps on one gradient sequence.

Tolerances: float32 runs at rtol 2e-6 (the same arithmetic; XLA and PyTorch
differ only in the last bit of a few operations). With bfloat16 in play, XLA
may keep excess precision between fused operations where PyTorch rounds
after each, so a moment stored in bfloat16 can land on a neighbouring value
and carry that into the next step: moments agree to two bfloat16 steps
(2^-6, relative to the value or, since mu is a sum of terms of mixed sign,
to the largest entry of the tensor), and parameters to what such a moment
moves them: lr * 2^-6 a step in float32, one bfloat16 step in bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trustedai_cl_vae_ad_tpu.models.wrapper import make_optimizer as jax_make_optimizer
from trustedai_cl_vae_ad_tpu_torch.ops.adam import Adam, make_optimizer, stochastic_round_bf16

STEPS = 5
SHAPES = {"w": (5, 7), "b": (7,)}


def _sequence(seed=0):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _run_optax(name, dtype, params, grads, lr=1e-3, lr_after_2=None):
    jd = jnp.dtype(dtype)
    p = {k: jnp.asarray(v).astype(jd) for k, v in params.items()}
    opt = jax_make_optimizer(lr, jd, name)
    state = opt.init(p)
    for i, g in enumerate(grads):
        if lr_after_2 is not None and i == 2:
            state.hyperparams["learning_rate"] = jnp.asarray(lr_after_2, jnp.float32)
        updates, state = opt.update({k: jnp.asarray(v).astype(jd) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, updates)
    inner = state.inner_state[0]
    f32 = lambda tree: {k: np.asarray(v.astype(jnp.float32)) for k, v in tree.items()}
    return f32(p), f32(inner.mu), f32(inner.nu), int(inner.count), inner.mu["w"].dtype


def _run_port(name, dtype, params, grads, lr=1e-3, lr_after_2=None):
    td = getattr(torch, dtype)
    p = {k: torch.from_numpy(v.copy()).to(td) for k, v in params.items()}
    opt = make_optimizer(p, lr, param_dtype=td, name=name)
    for i, g in enumerate(grads):
        if lr_after_2 is not None and i == 2:
            opt.learning_rate = lr_after_2
        opt.step([torch.from_numpy(g[k]).to(td) for k in opt.names])
    state = opt.state_dict()
    f32 = lambda d: {k: v.float().numpy() for k, v in d.items()}
    return f32(p), f32(state["mu"]), f32(state["nu"]), state["count"], state["mu"]["w"].dtype


CASES = [
    ("adam", "float32", 2e-6, 2e-6),
    ("adam_lean", "float32", 2.0 ** -6, 1e-7),
    ("adam_lean", "bfloat16", 2.0 ** -6, 2.0 ** -7),
]


@pytest.mark.parametrize("name, dtype, moment_rtol, param_rtol", CASES,
                         ids=[f"{n}-{d}" for n, d, _, _ in CASES])
def test_five_steps_match_optax(name, dtype, moment_rtol, param_rtol):
    params, grads = _sequence()
    jp, jmu, jnu, jcount, jmu_dtype = _run_optax(name, dtype, params, grads)
    tp, tmu, tnu, tcount, tmu_dtype = _run_port(name, dtype, params, grads)
    assert tcount == jcount == STEPS
    assert str(tmu_dtype).split(".")[-1] == str(jmu_dtype)
    for k in SHAPES:
        lean = name == "adam_lean"
        for got, ref in ((tmu[k], jmu[k]), (tnu[k], jnu[k])):
            atol = moment_rtol * float(np.abs(ref).max()) if lean else 1e-12
            np.testing.assert_allclose(got, ref, rtol=moment_rtol, atol=atol, err_msg=k)
        np.testing.assert_allclose(tp[k], jp[k], rtol=param_rtol,
                                   atol=STEPS * 1e-3 * 2.0 ** -6 if lean else 1e-7, err_msg=k)
        assert np.abs(tp[k] - params[k]).max() > 1e-3  # the steps moved something


@pytest.mark.parametrize("name, dtype, moment_rtol, param_rtol", CASES[:1] + CASES[2:],
                         ids=["adam-float32", "adam_lean-bfloat16"])
def test_learning_rate_dial_matches_optax(name, dtype, moment_rtol, param_rtol):
    params, grads = _sequence(seed=1)
    jp = _run_optax(name, dtype, params, grads, lr_after_2=1e-2)[0]
    tp = _run_port(name, dtype, params, grads, lr_after_2=1e-2)[0]
    undialled = _run_port(name, dtype, params, grads)[0]
    for k in SHAPES:
        np.testing.assert_allclose(tp[k], jp[k], rtol=param_rtol,
                                   atol=1e-3 if name == "adam_lean" else 1e-7, err_msg=k)
        assert np.abs(tp[k] - undialled[k]).max() > 1e-2


def test_plain_adam_on_bfloat16_params_stays_finite():
    """optax keeps every injected hyperparameter of ``optax.adam`` in the
    parameters' dtype, so with bfloat16 parameters b2 = 0.999 rounds to 1,
    the bias correction 1 - b2**t is 0 and the JAX package's ``adam`` gives
    NaN (recorded in ROADMAP.md queue 3). The port keeps b2 a Python float
    and stays finite; ``adam_lean`` is the default there in both packages."""
    params, grads = _sequence(seed=2)
    jp = _run_optax("adam", "bfloat16", params, grads)[0]
    assert all(np.isnan(v).all() for v in jp.values())
    tp = _run_port("adam", "bfloat16", params, grads)[0]
    lean = _run_port("adam_lean", "bfloat16", params, grads)[0]
    for k in SHAPES:
        assert np.isfinite(tp[k]).all()
        np.testing.assert_allclose(tp[k], lean[k], rtol=2.0 ** -6, atol=1e-3)


def test_make_optimizer_names_and_defaults():
    p = {"w": torch.zeros(3)}
    assert make_optimizer(p, 1e-3).name == "adam"
    lean = make_optimizer({"w": torch.zeros(3, dtype=torch.bfloat16)}, 1e-3,
                          param_dtype=torch.bfloat16)
    assert lean.name == "adam_lean" and lean.widen_nu
    assert lean.mu[0].dtype == lean.nu[0].dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        make_optimizer(p, 1e-3, name="adam_fp8")
    with pytest.raises(ValueError) as torch_err:
        make_optimizer(p, 1e-3, name="sgd")
    with pytest.raises(ValueError) as jax_err:
        jax_make_optimizer(1e-3, name="sgd")
    assert str(torch_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="no gradient"):
        make_optimizer(p, 1e-3).step([None])


def test_state_dict_round_trip_continues_exactly():
    params, grads = _sequence(seed=3)
    p1 = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    a = make_optimizer(p1, 1e-3)
    for g in grads[:3]:
        a.step([torch.from_numpy(g[k]) for k in a.names])
    p2 = {k: v.clone() for k, v in p1.items()}
    b = make_optimizer(p2, 1e-3)
    b.load_state_dict({"count": a.count, "mu": {k: v.clone() for k, v in a.state_dict()["mu"].items()},
                       "nu": {k: v.clone() for k, v in a.state_dict()["nu"].items()}})
    for g in grads[3:]:
        a.step([torch.from_numpy(g[k]) for k in a.names])
        b.step([torch.from_numpy(g[k]) for k in b.names])
    for k in SHAPES:
        assert torch.equal(p1[k], p2[k])
    with pytest.raises(KeyError):
        b.load_state_dict({"count": 0, "mu": {}, "nu": {}})


def test_stochastic_rounding_is_unbiased_and_reproducible():
    lo, hi = 1.0, 1.0 + 2.0 ** -7            # neighbouring bfloat16 values
    value = lo + 0.3 * (hi - lo)
    x = torch.full((200_000,), value, dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)
    r = stochastic_round_bf16(x, gen)
    assert r.dtype == torch.bfloat16
    assert set(r.float().unique().tolist()) == {lo, hi}
    # P(up) = 0.3: the mean is unbiased; 5 sigma of 200k Bernoulli draws
    p_up = float((r.float() == hi).float().mean())
    assert abs(p_up - 0.3) < 5 * (0.3 * 0.7 / 200_000) ** 0.5
    assert abs(float(r.float().mean()) - value) < 2e-5
    # round-to-nearest would always give lo
    assert float(x[:1].to(torch.bfloat16)) == lo
    again = stochastic_round_bf16(x, torch.Generator().manual_seed(7))
    assert torch.equal(r, again)
    # exact bfloat16 values and negatives pass through / round symmetrically
    exact = torch.tensor([0.0, 1.0, -2.5, 3.0e-5]).to(torch.bfloat16).float()
    assert torch.equal(stochastic_round_bf16(exact, gen).float(), exact)
    neg = stochastic_round_bf16(-x, torch.Generator().manual_seed(7))
    assert torch.equal(neg.float(), -r.float())


def test_adam_lean_stochastic_nu_is_seeded():
    params, grads = _sequence(seed=4)

    def run(seed):
        p = {k: torch.from_numpy(v.copy()).to(torch.bfloat16) for k, v in params.items()}
        opt = make_optimizer(p, 1e-3, param_dtype=torch.bfloat16, stochastic_round_nu=True,
                             generator=torch.Generator().manual_seed(seed))
        for g in grads:
            opt.step([torch.from_numpy(g[k]).to(torch.bfloat16) for k in opt.names])
        return opt.state_dict()["nu"]

    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    nearest = _run_port("adam_lean", "bfloat16", params, grads)[2]
    for k in a:  # dithered, yet within one bfloat16 step of round-to-nearest
        np.testing.assert_allclose(a[k].float().numpy(), nearest[k], rtol=2.0 ** -6, atol=1e-12)
    assert isinstance(make_optimizer({"w": torch.zeros(2)}, 1e-3), Adam)
