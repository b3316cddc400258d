"""The port's global and per-dimension moments (plain versions, which the CPU
runs) against the JAX package's ``global_moments`` and ``perdim_moments``:
their Pallas kernels in interpret mode and their jnp references. Tolerances: rtol 1e-5 / atol 1e-6 on values (the sums are taken
in another order), rtol 1e-4 / atol 1e-5 on gradients, as tests/test_moments.py
holds the JAX kernel to its own reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustedai_cl_vae_ad_tpu.ops import moments as jmoments
from trustedai_cl_vae_ad_tpu_torch.ops import moments as tmoments

GRAD_WEIGHTS = (0.3, -0.7, 1.1, 0.9)


def _z(shape, seed=2):
    return (np.random.RandomState(seed).randn(*shape) * 1.7 + 0.3).astype(np.float32)


def _jax_interpret(fn):
    old = jmoments._INTERPRET
    jmoments._INTERPRET = True
    try:
        return fn()
    finally:
        jmoments._INTERPRET = old


def _weighted_sum(ms):
    return sum(w * m for w, m in zip(GRAD_WEIGHTS, ms))


@pytest.mark.parametrize("shape", [(16, 128), (12, 6)], ids=["16x128", "12x6"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_values_match_jax_kernel_and_reference(shape, dtype):
    z = _z(shape)
    jz = jnp.asarray(z).astype(dtype)
    tz = torch.from_numpy(z).to(getattr(torch, dtype))
    pallas = _jax_interpret(lambda: [np.asarray(v) for v in jmoments.global_moments(jz)])
    ref = [np.asarray(v) for v in jmoments.global_moments_reference(jz)]
    got = [v.numpy() for v in tmoments.global_moments(tz)]
    plain = [v.numpy() for v in tmoments.global_moments_reference(tz)]
    for g, p, a, b in zip(got, plain, pallas, ref):
        assert g.dtype == np.float32 and g.shape == ()
        np.testing.assert_allclose(g, a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p, b, rtol=1e-5, atol=1e-6)


def test_constant_input_gives_zero_skew_and_kurtosis_and_finite_gradients():
    # a power-of-two constant: the mean is exact, so var is exactly 0
    tz = torch.full((8, 4), 2.0, requires_grad=True)
    m, var, skew, kurt = tmoments.global_moments(tz)
    assert float(m) == 2.0 and float(var) == 0.0 and float(skew) == 0.0 and float(kurt) == 0.0
    _weighted_sum((m, var, skew, kurt)).backward()
    jg = jax.grad(lambda z: _weighted_sum(jmoments.global_moments(z)))(jnp.full((8, 4), 2.0))
    assert torch.isfinite(tz.grad).all()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_grad(dtype):
    z = _z((16, 128), seed=3)
    jz = jnp.asarray(z).astype(dtype)
    jg = _jax_interpret(
        lambda: jax.grad(lambda v: _weighted_sum(jmoments.global_moments(v)))(jz))
    tz = torch.from_numpy(z).to(getattr(torch, dtype)).requires_grad_(True)
    _weighted_sum(tmoments.global_moments(tz)).backward()
    assert tz.grad.dtype == tz.dtype and jg.dtype == jz.dtype
    # bfloat16 gradients are rounded to 8 bits; one step of that is 2^-8
    rtol = 1e-4 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(tz.grad.float().numpy(), np.asarray(jg.astype(jnp.float32)),
                               rtol=rtol, atol=1e-5)


def test_analytic_backward_equals_autograd_of_plain_forward():
    z = torch.from_numpy(_z((12, 6), seed=4))
    za = z.clone().requires_grad_(True)
    _weighted_sum(tmoments.global_moments_reference(za)).backward()
    zb = z.clone().requires_grad_(True)
    _weighted_sum(tmoments.global_moments(zb)).backward()
    np.testing.assert_allclose(zb.grad.numpy(), za.grad.numpy(), rtol=1e-4, atol=1e-6)
    # one unused output: its upstream gradient is zero, not an error
    zc = z.clone().requires_grad_(True)
    tmoments.global_moments(zc)[3].backward()
    zd = z.clone().requires_grad_(True)
    tmoments.global_moments_reference(zd)[3].backward()
    np.testing.assert_allclose(zc.grad.numpy(), zd.grad.numpy(), rtol=1e-4, atol=1e-6)


def test_weighted_moments_match_jax_and_drop_weight_zero_rows():
    z = _z((10, 6), seed=5)
    ones = np.ones(10, np.float32)
    got = [v.numpy() for v in tmoments.global_moments_weighted(torch.from_numpy(z),
                                                              torch.from_numpy(ones))]
    plain = [v.numpy() for v in tmoments.global_moments(torch.from_numpy(z))]
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g, p, rtol=1e-5, atol=1e-6)
    w = ones.copy()
    w[[2, 7]] = 0.0
    masked = [v.numpy() for v in tmoments.global_moments_weighted(torch.from_numpy(z),
                                                                 torch.from_numpy(w))]
    kept = [v.numpy() for v in tmoments.global_moments(torch.from_numpy(z[w > 0]))]
    jmasked = [np.asarray(v) for v in jmoments.global_moments_weighted(jnp.asarray(z),
                                                                       jnp.asarray(w))]
    for a, b, c in zip(masked, kept, jmasked):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)
    # and its autograd gradient agrees with jax's
    tz = torch.from_numpy(z).requires_grad_(True)
    _weighted_sum(tmoments.global_moments_weighted(tz, torch.from_numpy(w))).backward()
    jg = jax.grad(lambda v: _weighted_sum(
        jmoments.global_moments_weighted(v, jnp.asarray(w))))(jnp.asarray(z))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)
    assert float(tz.grad[[2, 7]].abs().max()) == 0.0


@pytest.mark.parametrize("bad, error", [
    (lambda: torch.zeros(4, 4, dtype=torch.float64), TypeError),
    (lambda: torch.zeros(4, 4, dtype=torch.float16), TypeError),
    (lambda: torch.zeros(16), ValueError),
    (lambda: torch.zeros(2, 2, 4), ValueError),
    (lambda: torch.zeros(0, 4), ValueError),
    (lambda: torch.zeros(4, 6).t(), ValueError),
], ids=["float64", "float16", "1-D", "3-D", "empty", "non-contiguous"])
def test_bad_inputs_raise(bad, error):
    with pytest.raises(error):
        tmoments.global_moments(bad())


def test_cpu_tensors_never_count_as_kernel_launches():
    before = (tmoments.launches, tmoments.bwd_launches)
    z = torch.from_numpy(_z((4, 8))).requires_grad_(True)
    tmoments.global_moments(z)[3].backward()
    assert (tmoments.launches, tmoments.bwd_launches) == before
    assert tmoments.forward_blocks(torch.empty(256, 2000)) == 500
    assert tmoments.forward_blocks(torch.empty(7, 13)) == 1
    assert tmoments.forward_blocks(torch.empty(4096, 4096)) == 1024


# -- per-dimension moments ------------------------------------------------------------

def _perdim_z(shape, seed=2, constant_column=None):
    z = _z(shape, seed)
    if constant_column is not None:
        z[:, constant_column] = 2.0  # exact in float32 and bfloat16: var is exactly 0
    return z


def _rows_sum(ms, gw):
    return sum((torch.from_numpy(w) if isinstance(m, torch.Tensor) else jnp.asarray(w)) @ m
               for w, m in zip(gw, ms))


PERDIM_CASES = [((16, 128), None), ((12, 6), None), ((1, 7), None), ((9, 5), 3)]


@pytest.mark.parametrize("shape, const", PERDIM_CASES,
                         ids=["16x128", "12x6", "batch-of-1", "constant-column"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perdim_values_match_jax_kernel_and_reference(shape, const, dtype):
    z = _perdim_z(shape, constant_column=const)
    jz = jnp.asarray(z).astype(dtype)
    tz = torch.from_numpy(z).to(getattr(torch, dtype))
    pallas = _jax_interpret(lambda: [np.asarray(v) for v in jmoments.perdim_moments(jz)])
    ref = [np.asarray(v) for v in jmoments.perdim_moments_reference(jz)]
    got = [v.numpy() for v in tmoments.perdim_moments(tz)]
    plain = [v.numpy() for v in tmoments.perdim_moments_reference(tz)]
    packed = tmoments.perdim_moments_packed(tz)
    assert packed.shape == (4, shape[1]) and packed.dtype == torch.float32
    for g, p, a, b in zip(got, plain, pallas, ref):
        assert g.dtype == np.float32 and g.shape == (shape[1],)
        np.testing.assert_allclose(g, a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p, b, rtol=1e-5, atol=1e-6)
    if shape[0] == 1:
        assert all(float(np.abs(g).max()) == 0.0 for g in got[1:])
    if const is not None:
        assert [float(g[const]) for g in got] == [2.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("shape, const", [((16, 128), None), ((9, 5), 3), ((1, 7), None)],
                         ids=["16x128", "constant-column", "batch-of-1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perdim_gradients_match_jax_grad_through_the_custom_vjp(shape, const, dtype):
    z = _perdim_z(shape, seed=3, constant_column=const)
    gw = np.random.RandomState(7).randn(4, shape[1]).astype(np.float32)
    jz = jnp.asarray(z).astype(dtype)
    jg = _jax_interpret(
        lambda: jax.grad(lambda v: _rows_sum(jmoments.perdim_moments(v), gw))(jz))
    tz = torch.from_numpy(z).to(getattr(torch, dtype)).requires_grad_(True)
    _rows_sum(tmoments.perdim_moments(tz), gw).backward()
    assert tz.grad.dtype == tz.dtype and jg.dtype == jz.dtype
    assert torch.isfinite(tz.grad).all()  # a constant column has a finite gradient
    # bfloat16 gradients are rounded to 8 bits; one step of that is 2^-8
    rtol = 1e-4 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(tz.grad.float().numpy(), np.asarray(jg.astype(jnp.float32)),
                               rtol=rtol, atol=1e-5)


def test_perdim_analytic_backward_equals_autograd_of_plain_forward():
    z = torch.from_numpy(_z((12, 6), seed=4))
    gw = np.random.RandomState(8).randn(4, 6).astype(np.float32)
    za = z.clone().requires_grad_(True)
    _rows_sum(tmoments.perdim_moments_reference(za), gw).backward()
    zb = z.clone().requires_grad_(True)
    _rows_sum(tmoments.perdim_moments(zb), gw).backward()
    np.testing.assert_allclose(zb.grad.numpy(), za.grad.numpy(), rtol=1e-4, atol=1e-6)
    # the step-by-step plain backward is what the Function ran
    out = tmoments.perdim_moments_packed(z)
    direct = tmoments.perdim_moments_backward_reference(z, out, torch.from_numpy(gw))
    np.testing.assert_allclose(zb.grad.numpy(), direct.numpy(), rtol=1e-6, atol=1e-9)
    # KurtosisSingle's use: the variance row is unused, its gradient arrives as zeros
    def single(ms):
        m, _var, skew, kurt = ms
        return ((kurt - 1.8) ** 2).mean() + (skew ** 2).mean() + torch.sqrt((m ** 2).sum())
    zc = z.clone().requires_grad_(True)
    single(tmoments.perdim_moments(zc)).backward()
    zd = z.clone().requires_grad_(True)
    single(tmoments.perdim_moments_reference(zd)).backward()
    np.testing.assert_allclose(zc.grad.numpy(), zd.grad.numpy(), rtol=1e-4, atol=1e-6)


def test_perdim_weighted_moments_match_jax_and_drop_weight_zero_rows():
    z = _z((10, 6), seed=5)
    ones = np.ones(10, np.float32)
    got = [v.numpy() for v in tmoments.perdim_moments_weighted(torch.from_numpy(z),
                                                              torch.from_numpy(ones))]
    plain = [v.numpy() for v in tmoments.perdim_moments(torch.from_numpy(z))]
    for g, p in zip(got, plain):  # all-ones weights: the unweighted formulas
        np.testing.assert_allclose(g, p, rtol=1e-5, atol=1e-6)
    w = ones.copy()
    w[[2, 7]] = 0.0
    masked = [v.numpy() for v in tmoments.perdim_moments_weighted(torch.from_numpy(z),
                                                                 torch.from_numpy(w))]
    kept = [v.numpy() for v in tmoments.perdim_moments(torch.from_numpy(z[w > 0]))]
    jmasked = [np.asarray(v) for v in jmoments.perdim_moments_weighted(jnp.asarray(z),
                                                                       jnp.asarray(w))]
    for a, b, c in zip(masked, kept, jmasked):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)
    gw = np.random.RandomState(9).randn(4, 6).astype(np.float32)
    tz = torch.from_numpy(z).requires_grad_(True)
    _rows_sum(tmoments.perdim_moments_weighted(tz, torch.from_numpy(w)), gw).backward()
    jg = jax.grad(lambda v: _rows_sum(
        jmoments.perdim_moments_weighted(v, jnp.asarray(w)), gw))(jnp.asarray(z))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)
    assert float(tz.grad[[2, 7]].abs().max()) == 0.0


@pytest.mark.parametrize("bad, error", [
    (lambda: torch.zeros(4, 4, dtype=torch.float64), TypeError),
    (lambda: torch.zeros(4, 4, dtype=torch.float16), TypeError),
    (lambda: torch.zeros(16), ValueError),
    (lambda: torch.zeros(2, 2, 4), ValueError),
    (lambda: torch.zeros(0, 4), ValueError),
    (lambda: torch.zeros(4, 6).t(), ValueError),
], ids=["float64", "float16", "1-D", "3-D", "empty", "non-contiguous"])
def test_perdim_bad_inputs_raise(bad, error):
    with pytest.raises(error):
        tmoments.perdim_moments(bad())


def test_perdim_backward_checks_its_packed_arguments():
    z = torch.from_numpy(_z((4, 8)))
    out = tmoments.perdim_moments_packed(z)
    with pytest.raises(ValueError, match="moments"):
        tmoments.perdim_moments_backward(z, out[:, :4].contiguous(), out)
    with pytest.raises(ValueError, match="gout"):
        tmoments.perdim_moments_backward(z, out, out.double())
    with pytest.raises(ValueError, match="gout"):
        tmoments.global_moments_backward(z, tmoments.global_moments_packed(z), torch.ones(3))


def test_perdim_cpu_tensors_never_count_as_kernel_launches():
    before = (tmoments.launches, tmoments.bwd_launches, tmoments.perdim_launches,
              tmoments.perdim_bwd_launches)
    z = torch.from_numpy(_z((4, 8))).requires_grad_(True)
    tmoments.perdim_moments(z)[3].sum().backward()
    assert (tmoments.launches, tmoments.bwd_launches, tmoments.perdim_launches,
            tmoments.perdim_bwd_launches) == before
