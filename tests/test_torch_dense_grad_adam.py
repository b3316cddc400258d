"""The plain versions of ``ops/dense_grad_adam.py`` against the archived JAX
probes (``benchmarks/r11_kernel.py``, ``benchmarks/r11_diag.py``), whose
Pallas kernels run in interpret mode on the CPU, on the same numpy inputs.

Tolerances. ``epi_bf16``, the product alone and the copy: equal (rounding to
bfloat16 after every operation is what XLA's CPU code does too; a float32 sum
rounded to bfloat16 hides the order of its terms at these sizes). Float32
arithmetic: equal except on at most 1% of the elements, which differ by one
step of the dtype (XLA may contract ``a * b + c`` into one rounding, which
moves a float32 result by one step and now and then flips a bfloat16
rounding; the order of the K sums does the same to the fused kernels).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga

from torch_port_helpers import (
    assert_one_step_apart,
    load_r11_probes,
    np_to_torch_exact,
    torch_to_np_exact,
)

ADAM = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8)
ALIGNED = (16, 256, 128)  # gives the TPU tiler a 128-multiple divisor: the Pallas route runs
RAGGED = [(5, 37, 53), (1, 1, 1)]
NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float32": np.float32}


@pytest.fixture
def probes(monkeypatch, tmp_path):
    return load_r11_probes(monkeypatch, tmp_path)[:3]


def operands(shape, dtype="bfloat16", seed=0):
    """x, dz, w, mu, nu, g as numpy arrays with the probes' scales."""
    K, M, N = shape
    rng = np.random.default_rng(seed)
    dt = NP_DTYPES[dtype]

    def normal(s, scale):
        return (scale * rng.standard_normal(s)).astype(np.float32).astype(dt)

    return {"x": normal((K, M), 0.5), "dz": normal((K, N), 1e-3), "w": normal((M, N), 0.02),
            "mu": normal((M, N), 1e-4),
            "nu": (1e-6 * rng.random((M, N))).astype(np.float32).astype(dt),
            "g": normal((M, N), 1e-3)}


def tensors(ops, *names):
    return [np_to_torch_exact(ops[n]) for n in names]


def arrays(ops, *names):
    return [jnp.asarray(ops[n]) for n in names]


def set_diag_shape(monkeypatch, diag, shape):
    for name, value in zip("KMN", shape):
        monkeypatch.setattr(diag, name, value)


def compare_state(got, ref, label, exact=False):
    for name, a, b in zip(("w", "mu", "nu"), got, ref):
        a, b = torch_to_np_exact(a), np.asarray(b)
        if exact:
            assert np.array_equal(a, b), (label, name)
        else:
            assert_one_step_apart(a, b, f"{label} {name}")


@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("variant", ["epi_only", "epi_bf16"])
def test_epilogue_reference_matches_the_jax_kernel(probes, monkeypatch, variant, count):
    _kernel, diag, calls = probes
    set_diag_shape(monkeypatch, diag, ALIGNED)
    ops = operands(ALIGNED, seed=count)
    step, _ops, _floor = diag.build(variant)
    ref = step(*arrays(ops, "g", "w", "mu", "nu"), jnp.int32(count))
    assert calls, "the Pallas kernel did not run"
    reference = (dga.adam_epilogue_bf16_reference if variant == "epi_bf16"
                 else dga.adam_epilogue_reference)
    got = reference(*tensors(ops, "g", "w", "mu", "nu"), count=count, **ADAM)
    compare_state(got, ref, variant, exact=variant == "epi_bf16")
    assert not np.array_equal(torch_to_np_exact(got[0]), ops["w"]), "w did not move"


@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("x_transposed", [False, True], ids=["x_km", "x_mk"])
def test_fused_reference_matches_the_jax_kernel_and_its_reference(probes, monkeypatch,
                                                                  x_transposed, count):
    kernel, diag, calls = probes
    ops = operands(ALIGNED, seed=10 + count)
    kw = dict(count=jnp.int32(count), **ADAM)
    jax_ref = kernel.fused_dense_grad_adam_reference(*arrays(ops, "x", "dz", "w", "mu", "nu"),
                                                     **kw)
    if x_transposed:
        set_diag_shape(monkeypatch, diag, ALIGNED)
        ops["x"] = np.ascontiguousarray(ops["x"].T)
        step, _ops, _floor = diag.build("fused_xt")
        jax_kernel = step(*arrays(ops, "x", "dz", "w", "mu", "nu"), jnp.int32(count))
    else:
        jax_kernel = kernel.fused_dense_grad_adam(*arrays(ops, "x", "dz", "w", "mu", "nu"),
                                                  **kw)
    assert len(calls) == 1, "the Pallas route did not run (the tiler fell back)"
    for ref, label in ((jax_kernel, "kernel"), (jax_ref, "reference")):
        got = dga.fused_dense_grad_adam_reference(
            *tensors(ops, "x", "dz", "w", "mu", "nu"), count=count, x_transposed=x_transposed,
            **ADAM)
        compare_state(got, ref, f"fused vs the JAX {label}")


def test_product_and_copy_references_match_the_jax_kernels(probes, monkeypatch):
    _kernel, diag, calls = probes
    set_diag_shape(monkeypatch, diag, ALIGNED)
    ops = operands(ALIGNED, seed=3)
    step, _ops, _floor = diag.build("dot_only")
    ref = np.asarray(step(*arrays(ops, "x", "dz"), jnp.int32(1)))
    got = torch_to_np_exact(dga.dense_grad_reference(*tensors(ops, "x", "dz")))
    assert np.array_equal(got, ref)
    step, _ops, _floor = diag.build("copy_only")
    ref = step(*arrays(ops, "w", "mu", "nu"), jnp.int32(1))
    got = dga.stream_copy(*tensors(ops, "w", "mu", "nu"))
    compare_state(got, ref, "copy_only", exact=True)
    assert len(calls) == 2


@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [ALIGNED, *RAGGED], ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_match_the_jax_reference_at_any_shape(probes, shape, dtype, count):
    """The jnp reference takes any shape and dtype (the Pallas route does
    not): ragged sizes, one element, float32."""
    kernel, _diag, _calls = probes
    ops = operands(shape, dtype, seed=count)
    kw = dict(count=jnp.int32(count), **ADAM)
    ref = kernel.fused_dense_grad_adam_reference(*arrays(ops, "x", "dz", "w", "mu", "nu"), **kw)
    got = dga.fused_dense_grad_adam(*tensors(ops, "x", "dz", "w", "mu", "nu"), count=count,
                                    **ADAM)
    compare_state(got, ref, "fused")
    xt = dict(ops, x=np.ascontiguousarray(ops["x"].T))
    got = dga.fused_dense_grad_adam(*tensors(xt, "x", "dz", "w", "mu", "nu"), count=count,
                                    x_transposed=True, **ADAM)
    compare_state(got, ref, "fused, x transposed")
    # the step alone on a given gradient: adam_epilogue with the scalars of the reference
    cnt = jnp.asarray(count, jnp.float32)
    f32 = {k: jnp.asarray(v, jnp.float32) for k, v in ADAM.items()}
    ref = kernel.adam_epilogue(jnp.asarray(ops["g"]).astype(jnp.float32),
                               *arrays(ops, "w", "mu", "nu"), f32["lr"], f32["b1"], f32["b2"],
                               f32["eps"], 1.0 - f32["b1"] ** cnt, 1.0 - f32["b2"] ** cnt)
    got = dga.adam_epilogue_step(*tensors(ops, "g", "w", "mu", "nu"), count=count, **ADAM)
    compare_state(got, ref, "epilogue")
    g = dga.dense_grad(*tensors(ops, "x", "dz"))
    g64 = ops["x"].astype(np.float64).T @ ops["dz"].astype(np.float64)
    if dtype == "bfloat16":  # the float32 sum is far finer than its bfloat16 rounding
        assert_one_step_apart(torch_to_np_exact(g), g64.astype(np.float32).astype(
            ml_dtypes.bfloat16), "dense_grad", share=1.0)
    else:  # each of the K additions rounds once, at the scale of the sum
        np.testing.assert_allclose(torch_to_np_exact(g), g64, rtol=0,
                                   atol=shape[0] * 2.0 ** -23 * np.abs(g64).max())


@pytest.mark.parametrize("count", [1, 2, 5, 1000])
def test_scalars_are_the_float32_values_of_the_jax_probe(count):
    cnt = jnp.asarray(count, jnp.float32)
    want = [jnp.asarray(ADAM[k], jnp.float32) for k in ("lr", "b1", "b2", "eps")]
    want += [1.0 - want[1] ** cnt, 1.0 - want[2] ** cnt]
    got = dga.adam_scalars(count=count, **ADAM)
    assert [np.float32(v) for v in got] == [np.float32(v) for v in want]
    assert all(float(np.float32(v)) == v for v in got), "not exact in float32"
    # 1 - b2 is a float32 difference, 1.3e-5 off 0.001
    assert np.float32(1) - np.float32(got[2]) != np.float32(0.001)


def test_bf16_arithmetic_freezes_nu_as_the_probe_does():
    """b2 = 0.999 rounds to 1 in bfloat16, so 1 - b2 is 0 and nu stays."""
    ops = operands(RAGGED[0], seed=4)
    g, w, mu, nu = tensors(ops, "g", "w", "mu", "nu")
    dga.adam_epilogue_step(g, w, mu, nu, count=1, arithmetic="bfloat16", **ADAM)
    assert np.array_equal(torch_to_np_exact(nu), ops["nu"])
    assert not np.array_equal(torch_to_np_exact(mu), ops["mu"])


def test_wrappers_update_in_place_and_count_no_launch_on_the_cpu():
    ops = operands(RAGGED[0], seed=5)
    x, dz, w, mu, nu, g = tensors(ops, "x", "dz", "w", "mu", "nu", "g")
    before = dict(dga.launches)
    out = dga.fused_dense_grad_adam(x, dz, w, mu, nu, count=1, **ADAM)
    assert all(a is b for a, b in zip(out, (w, mu, nu)))
    out = dga.adam_epilogue_step(g, w, mu, nu, count=2, **ADAM)
    assert all(a is b for a, b in zip(out, (w, mu, nu)))
    assert not np.array_equal(torch_to_np_exact(w), ops["w"])
    buf = torch.empty_like(w)
    assert dga.dense_grad(x, dz, out=buf) is buf
    copies = dga.stream_copy(w, mu, nu)
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(copies, (w, mu, nu)))
    outs = tuple(torch.empty_like(t) for t in (w, mu, nu))
    assert all(a is b for a, b in zip(dga.stream_copy(w, mu, nu, out=outs), outs))
    assert all(a is b for a, b in zip(dga.stream_copy(w, mu, nu, out=(w, mu, nu)), (w, mu, nu)))
    assert dga.launches == before
    assert set(dga.launches) == {"fused", "fused_xt", "dense_grad", "stream_copy",
                                 "epilogue_bf16", "epilogue_f32"}


def _bad_inputs():
    ops = operands((4, 8, 6), seed=6)
    x, dz, w, mu, nu, g = tensors(ops, "x", "dz", "w", "mu", "nu", "g")
    fused = lambda **kw: dga.fused_dense_grad_adam(  # noqa: E731
        **{**dict(x=x, dz=dz, w=w, mu=mu, nu=nu, count=1, **ADAM), **kw})
    epi = lambda **kw: dga.adam_epilogue_step(  # noqa: E731
        **{**dict(g=g, w=w, mu=mu, nu=nu, count=1, **ADAM), **kw})
    state = torch.zeros((3, 8, 6), dtype=torch.bfloat16)
    wide = torch.zeros((8, 12), dtype=torch.bfloat16)
    return [
        ("float64 x", lambda: fused(x=x.double()), TypeError),
        ("float16 state", lambda: epi(g=g.half(), w=w.half(), mu=mu.half(), nu=nu.half()),
         TypeError),
        ("mixed dtypes", lambda: fused(mu=mu.float()), TypeError),
        ("a float32 gradient for a bfloat16 state", lambda: epi(g=g.float()), TypeError),
        ("bfloat16 arithmetic on float32 tensors",
         lambda: epi(g=g.float(), w=w.float(), mu=mu.float(), nu=nu.float(),
                     arithmetic="bfloat16"), TypeError),
        ("mixed devices", lambda: fused(dz=dz.to("meta")), ValueError),
        ("a meta state", lambda: epi(g=g.to("meta"), w=w.to("meta"), mu=mu.to("meta"),
                                     nu=nu.to("meta")), ValueError),
        ("non-contiguous w", lambda: fused(w=wide[:, ::2], mu=mu, nu=nu), ValueError),
        ("non-contiguous x", lambda: fused(x=x.t().contiguous().t()), ValueError),
        ("w and mu overlap", lambda: fused(mu=w), ValueError),
        ("mu and nu overlap", lambda: epi(mu=state[0], nu=state[:2].view(-1)[24:72].view(8, 6)),
         ValueError),
        ("w overlaps dz", lambda: dga.fused_dense_grad_adam(
            x=torch.zeros((8, 8), dtype=torch.bfloat16), dz=w[:, :].view(8, 6), w=w, mu=mu,
            nu=nu, count=1, **ADAM), ValueError),
        ("g overlaps nu", lambda: epi(g=nu), ValueError),
        ("K differs", lambda: fused(dz=torch.zeros((5, 6), dtype=torch.bfloat16)), ValueError),
        ("w of another shape", lambda: fused(w=torch.zeros((6, 8), dtype=torch.bfloat16)),
         ValueError),
        ("mu of another shape", lambda: fused(mu=torch.zeros((8, 5), dtype=torch.bfloat16)),
         ValueError),
        ("x transposed but given as (K, M)", lambda: fused(x_transposed=True), ValueError),
        ("a vector", lambda: dga.dense_grad(x[0], dz), ValueError),
        ("an empty matrix", lambda: dga.dense_grad(x[:0], dz[:0]), ValueError),
        ("count 0", lambda: fused(count=0), ValueError),
        ("an unknown arithmetic", lambda: epi(arithmetic="float16"), ValueError),
        ("out of another shape", lambda: dga.dense_grad(x, dz, out=torch.zeros(
            (6, 8), dtype=torch.bfloat16)), ValueError),
        ("out overlapping x", lambda: dga.dense_grad(
            torch.zeros((8, 6), dtype=torch.bfloat16), dz := torch.zeros(
                (8, 6), dtype=torch.bfloat16), out=dz[:6].view(6, 6)[:6]), ValueError),
        ("two copy outputs", lambda: dga.stream_copy(w, mu, nu, out=(w, mu)), ValueError),
        ("a copy output that is another source", lambda: dga.stream_copy(
            w, mu, nu, out=(mu, w, nu)), ValueError),
    ]


@pytest.mark.parametrize("index", range(25))
def test_wrappers_raise_on_what_the_kernels_do_not_take(index):
    cases = _bad_inputs()
    assert len(cases) == 25
    what, call, error = cases[index]
    with pytest.raises(error):
        call()
        pytest.fail(f"{what} did not raise")
