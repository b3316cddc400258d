"""The r11 probe harnesses of the port (``probes/r11.py``, ``probe_r11_torch.py``)
on the CPU against the archived JAX harnesses (``benchmarks/r11_diag.py``,
``benchmarks/r11_fused_dense_adam.py``) with their Pallas kernels in interpret
mode: the same numpy operands, the same four steps (three of warm-up, one
timed), the same state.

Tolerance: as in tests/test_torch_dense_grad_adam.py for one step (equal, or
one step of the dtype on at most 1% of the elements where XLA contracts a
multiply-add or sums K in another order); four steps carry a difference in
mu or nu into the next step's w, so up to 4% of the elements may differ, by
up to four steps, taken for mu at the size of its terms.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probe_r11_torch
from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga
from trustedai_cl_vae_ad_tpu_torch.probes import r11

from test_torch_dense_grad_adam import ALIGNED, arrays, operands, set_diag_shape, tensors
from torch_port_helpers import assert_one_step_apart, load_r11_probes, torch_to_np_exact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "benchmarks", "r11_results.jsonl")
STATE = {"dot_only": (), "copy_only": ("w", "mu", "nu")}
FIXED = {"dot_only": ("x", "dz"), "copy_only": (), "epi_bf16": ("g",), "epi_only": ("g",)}
EXACT = ("dot_only", "copy_only", "epi_bf16")


@pytest.fixture
def probes(monkeypatch, tmp_path):
    return load_r11_probes(monkeypatch, tmp_path)


def jax_steps(step, ops, variant, n_steps):
    """What ``r11_diag.run`` does with a built step: the state goes through
    ``n_steps`` calls with the count advancing from 1."""
    fixed = arrays(ops, *FIXED.get(variant, ("x", "dz")))
    state = arrays(ops, *STATE.get(variant, ("w", "mu", "nu")))
    for i in range(n_steps):
        out = step(*fixed, *state, jnp.int32(1 + i))
        if state:
            state = out
    return out if isinstance(out, (tuple, list)) else (out,)


def port_operands(ops, variant):
    names = ("x", "dz", "w", "mu", "nu", "g")
    out = dict(zip(names, tensors(ops, *names)))
    if variant == "fused_xt":
        out["x"] = out["x"].t().contiguous()
    return out


def compare(got, ref, variant, steps, ops):
    """After several steps mu and w are held to one step a step at the size
    of their terms (mu: the old mu and the gradient; w: the old w and the
    sum of its updates): where the terms cancel, a step of difference in one
    of them is many steps of the small result."""
    assert len(got) == len(ref)
    if variant in EXACT:
        for i, (a, b) in enumerate(zip(got, ref)):
            assert np.array_equal(torch_to_np_exact(a), np.asarray(b)), (variant, i)
        return
    g = ops["g"] if variant.startswith("epi") else (
        ops["x"].astype(np.float64).T @ ops["dz"].astype(np.float64))
    w0, w_ref = ops["w"].astype(np.float64), np.asarray(ref[0]).astype(np.float64)
    terms = [np.maximum(np.abs(w0), np.abs(w0 - w_ref)),
             np.maximum(np.abs(ops["mu"].astype(np.float64)), np.abs(g.astype(np.float64))),
             None]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert_one_step_apart(torch_to_np_exact(a), np.asarray(b), f"{variant} [{i}]",
                              share=0.01 * steps, terms=terms[i], updates=steps)


@pytest.mark.parametrize("variant", r11.DIAG_VARIANTS)
def test_diag_harness_follows_the_jax_harness_step_for_step(probes, monkeypatch, variant):
    _kernel, diag, calls, _fused = probes
    set_diag_shape(monkeypatch, diag, ALIGNED)
    ops = operands(ALIGNED, seed=7)
    step, _ops, _floor = diag.build("xla" if variant == "torch" else variant)
    jax_ops = dict(ops, x=np.ascontiguousarray(ops["x"].T)) if variant == "fused_xt" else ops
    ref = jax_steps(step, jax_ops, variant, r11.WARMUP + 1)
    assert bool(calls) == (variant != "torch"), "the Pallas route did not run"

    given = port_operands(ops, variant)
    rec, state = r11.run("diag", variant, shape=ALIGNED, steps=1, device="cpu", operands=given)
    compare(state, ref, variant, r11.WARMUP + 1, ops)
    if variant not in STATE:  # in place: the state is the operands
        assert all(a is given[k] for a, k in zip(state, ("w", "mu", "nu")))
        assert not np.array_equal(torch_to_np_exact(given["w"]), ops["w"])
    K, M, N = ALIGNED
    assert rec["variant"] == f"diag_{variant}" and (rec["K"], rec["M"], rec["N"]) == ALIGNED
    assert rec["device"] == "cpu" and rec["ms"] > 0 and rec["steps"] == 1
    assert rec["kernel"] == (None if variant == "torch" else {
        "fused": "fused", "fused_xt": "fused_xt", "dot_only": "dense_grad",
        "copy_only": "stream_copy", "epi_bf16": "epilogue_bf16",
        "epi_only": "epilogue_f32"}[variant]) and set(dga.launches) >= {rec["kernel"]} - {None}
    # no device number from a CPU run
    assert "event_ms" not in rec and "temp_gb" not in rec
    tensors_moved = {"dot_only": 1, "copy_only": 6, "epi_bf16": 7, "epi_only": 7}.get(variant, 6)
    with_product = variant not in ("copy_only", "epi_bf16", "epi_only")
    nbytes = 2 * (tensors_moved * M * N + with_product * (K * M + K * N))
    assert rec["floor_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)


@pytest.mark.parametrize("variant", r11.FUSED_VARIANTS)
def test_fused_harness_follows_the_jax_harness_step_for_step(probes, variant):
    _kernel, _diag, calls, fused = probes
    ops = operands(ALIGNED, seed=8)
    step = fused.build_step("xla" if variant == "torch" else variant)
    ref = jax_steps(step, ops, variant, r11.WARMUP + 2)
    assert bool(calls) == (variant == "fused")
    given = port_operands(ops, variant)
    rec, state = r11.run("fused", variant, shape=ALIGNED, steps=2, device="cpu", operands=given,
                         check=True)
    compare(state, ref, variant, r11.WARMUP + 2, ops)
    assert rec["shape"] == "custom" and rec["variant"] == variant
    assert (rec["K"], rec["M"], rec["N"]) == ALIGNED
    if variant == "fused":  # on the CPU the wrapper is the plain version: nothing to differ
        assert rec["check_shape"] == list(ALIGNED)
        assert rec["max_err_vs_scale"] == {"w": 0.0, "mu": 0.0, "nu": 0.0}
    else:
        assert "check_shape" not in rec


def test_shapes_and_scales_are_the_jax_harnesses(probes):
    _kernel, diag, _calls, fused = probes
    assert r11.SHAPES == fused.SHAPES
    assert r11.DIAG_SHAPE == (diag.K, diag.M, diag.N)
    assert r11.CHECK_SHAPES == {"enc": (768, 12800, 4000), "enc4096": (768, 12800, 4096),
                                "dec": (768, 2000, 13440)}
    gen = torch.Generator().manual_seed(0)
    ops = r11.make_operands(64, 512, 384, "cpu", gen)
    assert {k: tuple(v.shape) for k, v in ops.items()} == {
        "x": (64, 512), "dz": (64, 384), "w": (512, 384), "mu": (512, 384), "nu": (512, 384)}
    assert all(v.dtype == torch.bfloat16 and v.is_contiguous() for v in ops.values())
    for name, scale in (("x", 0.5), ("dz", 1e-3), ("w", 0.02), ("mu", 1e-4)):
        assert float(ops[name].float().std()) == pytest.approx(scale, rel=0.05), name
        assert abs(float(ops[name].float().mean())) < 0.05 * scale, name
    nu = ops["nu"].float()
    assert float(nu.min()) >= 0 and float(nu.max()) <= 1e-6
    assert float(nu.mean()) == pytest.approx(0.5e-6, rel=0.05)
    g = r11.make_gradient(512, 384, "cpu", gen)
    assert float(g.float().std()) == pytest.approx(1e-3, rel=0.05)
    again = r11.make_operands(64, 512, 384, "cpu", torch.Generator().manual_seed(0),
                              transposed_x=True)
    assert again["x"].shape == (512, 64) and again["x"].is_contiguous()
    assert torch.equal(again["x"].t(), ops["x"]) and torch.equal(again["w"], ops["w"])


@pytest.mark.parametrize("variant", r11.TPU_ONLY)
def test_tpu_only_variants_are_refused(variant, tmp_path, capsys):
    """``xla_opt`` and ``fused_opt`` compile under TPU compiler options;
    ``fused_big`` measures the TPU kernel's block budget, and the port's fused
    kernel has one tile configuration a shape. Each is refused with its reason."""
    why = f"{r11.TPU_ONLY[variant]} and has no counterpart on a GPU"
    assert "TPU" in why
    with pytest.raises(ValueError, match=re.escape(why)):
        r11.run("fused", variant, shape=ALIGNED, device="cpu")
    with pytest.raises(SystemExit):
        probe_r11_torch.main(["--device", "cpu", "--variants", variant,
                              "--out", str(tmp_path / "out.jsonl")])
    assert why in capsys.readouterr().err
    assert not (tmp_path / "out.jsonl").exists()
    assert variant not in r11.DIAG_VARIANTS + r11.FUSED_VARIANTS


def test_harness_rejects_what_it_does_not_have():
    with pytest.raises(ValueError):
        r11.run("diag2", "fused", shape=ALIGNED, device="cpu")
    with pytest.raises(ValueError):
        r11.run("fused", "epi_only", shape=ALIGNED, device="cpu")
    with pytest.raises(ValueError):
        r11.run("diag", "fused", shape=ALIGNED, device="cpu", steps=0)
    with pytest.raises(ValueError):
        r11.build("xla", 4, 8, 8, "cpu", torch.Generator())


def test_cli_runs_both_harnesses_on_the_cpu_and_writes_only_its_own_file(tmp_path, capsys):
    with open(RESULTS, "rb") as f:
        before = f.read()
    launches = dict(dga.launches)
    out = tmp_path / "sub" / "records.jsonl"
    rc = probe_r11_torch.main(["--device", "cpu", "--harness", "diag", "--K", "8", "--M", "40",
                               "--N", "24", "--steps", "2", "--out", str(out)])
    assert rc == 0
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["variant"] for r in records] == [
        f"diag_{v}" for v in ("torch", "fused", "fused_xt", "dot_only", "epi_only")]
    assert all((r["K"], r["M"], r["N"]) == (8, 40, 24) and r["card"] == "cpu" for r in records)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == records
    with pytest.raises(SystemExit):  # the fused harness takes named shapes
        probe_r11_torch.main(["--device", "cpu", "--N", "24", "--out", str(out)])
    with pytest.raises(SystemExit):
        probe_r11_torch.main(["--device", "cpu", "--shapes", "enc,nowhere", "--out", str(out)])
    assert dga.launches == launches, "a CPU run counted a kernel launch"
    with open(RESULTS, "rb") as f:
        assert f.read() == before, "benchmarks/r11_results.jsonl was written"


def test_cli_defaults_to_the_card_and_says_so_without_one(capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert probe_r11_torch.main(["--out", str(tmp_path / "o.jsonl")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        r11.run("diag", "fused", shape=ALIGNED)
    default = probe_r11_torch.main.__globals__["REPO"]
    assert default == REPO  # the default --out lies under build/, which git ignores


def test_bounds_of_the_probes_shapes():
    """kernel_bounds_torch.py has a row for every shape the card run times:
    rows 4-9 are marked ported (as every row is, now that row 11 has its
    kernel), and all but the product alone are bound by the bytes of w, mu,
    nu."""
    import kernel_bounds_torch as kb

    table = kb.bounds()
    assert {r["row"] for r in table if not r["ported"]} == set()
    assert {4, 5, 6, 7, 8, 9, 11} <= {r["row"] for r in table if r["ported"]}
    by_shape = {(r["row"], r["shapes"]): r for r in table}
    enc = by_shape[(4, "K=768 M=268800 N=4000 bf16")]
    assert enc["bytes"] == 2 * (768 * 268800 + 768 * 4000 + 6 * 268800 * 4000)
    assert enc["bound_ms"] == pytest.approx(3.97654, abs=1e-5) and enc["bound_by"] == "bytes"
    assert by_shape[(4, "K=768 M=4000 N=268800 bf16")]["bound_ms"] == enc["bound_ms"]
    dec = by_shape[(4, "K=768 M=2000 N=134400 bf16")]
    assert dec["bound_ms"] == pytest.approx(2 * (768 * 136400 + 6 * 268.8e6) / 3.35e12 * 1e3)
    K, M, N = r11.DIAG_SHAPE
    for row, tensors_moved in ((7, 6), (8, 7), (9, 7)):
        r = next(r for r in table if r["row"] == row)
        assert r["bytes"] == 2 * tensors_moved * M * N and r["bound_by"] == "bytes"
    assert by_shape[(9, "4x (268800, 4000) bf16")]["bound_ms"] == pytest.approx(
        14 * 268800 * 4000 / 3.35e12 * 1e3)
    assert by_shape[(9, "4x (2000, 134400) bf16")]["bytes"] == 14 * 2000 * 134400
    floor = r11.HBM_BYTES_PER_S
    assert floor == kb.HBM_BYTES_PER_S
