"""The r11 probes: one Adam step on one dense kernel, fused and taken apart.

The port's copy of the two archived harnesses ``benchmarks/
r11_fused_dense_adam.py`` (harness ``fused``: the step with the gradient
product fused in, at the flagship's two dense shapes at batch 768) and
``benchmarks/r11_diag.py`` (harness ``diag``: the same step taken apart at a
reduced encoder shape: product alone, epilogue alone, copy alone). Variants:

  torch      counterpart of ``xla``: ``torch.matmul`` for the product (which
             is outside any kernel there too), then the plain epilogue
             written in place; allocates the (M, N) gradient every step
  fused      ``ops.dense_grad_adam.fused_dense_grad_adam`` (bf16 on the rule:
             the tensor cores, 128 x 128 outputs a block)
  fused_xt   x given as (M, K)
  dot_only   the product alone, written as (M, N) in the operands' dtype
  copy_only  w, mu, nu streamed through unchanged (the bandwidth control)
  epi_bf16   the step on a given gradient, every operation in bfloat16
  epi_only   the step on a given gradient, float32 arithmetic

``xla_opt``, ``fused_opt`` and ``fused_big`` have no counterpart here
(``TPU_ONLY`` says why). Operands are made on the device from an explicit
``torch.Generator``. A record keeps the JAX harnesses' keys (``shape`` /
``variant``, ``K``, ``M``, ``N``, ``ms``, ``max_err_vs_scale``,
``check_shape``); ``kernel`` names the variant's launch counter in
``ops.dense_grad_adam.launches`` (null for ``torch``), ``floor_ms`` is the
bytes moved once over an H100's 3.35 TB/s, ``event_ms`` the CUDA-event time
beside the host clock's ``ms``, and ``temp_gb`` what one step allocates
beyond what is resident (the counterpart of ``hbm_temp_gb``: 0 for a kernel
that works in place).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga

#: (K = batch, M = in features, N = out features): the flagship at batch 768
SHAPES = {
    "enc": (768, 268800, 4000),
    "dec": (768, 2000, 134400),
    # the encoder shape with a latent of 2048: N a multiple of 128
    "enc4096": (768, 268800, 4096),
}
#: reduced shapes at which the fused harness holds the kernel against the plain version
CHECK_SHAPES = {"enc": (768, 12800, 4000), "enc4096": (768, 12800, 4096),
                "dec": (768, 2000, 13440)}
DIAG_SHAPE = (768, 12800, 4000)
ADAM = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8)
HBM_BYTES_PER_S = 3.35e12  # NVIDIA's H100 SXM data sheet
WARMUP = 3

FUSED_VARIANTS = ("torch", "fused")
DIAG_VARIANTS = ("torch", "fused", "fused_xt", "dot_only", "copy_only", "epi_bf16",
                 "epi_only")
#: the archived harnesses' variants that measure a TPU setting, and why the port has none
TPU_ONLY = {
    "xla_opt": "compiles under TPU compiler options (xla_tpu_scoped_vmem_limit_kib)",
    "fused_opt": "compiles under TPU compiler options (xla_tpu_scoped_vmem_limit_kib)",
    # the port's fused kernel has one tile configuration a shape (ops.dense_grad_adam's
    # fused_arrangement), so there is no second block budget to measure
    "fused_big": "measures a 4x larger VMEM block budget of the TPU kernel (bm 256 -> 1024, "
                 "the grid-step overhead of a TPU core)",
}
_FUSED_KW = {"fused": {}, "fused_xt": {"x_transposed": True}}


def make_operands(K: int, M: int, N: int, device, generator: torch.Generator,
                  transposed_x: bool = False, dtype: torch.dtype = torch.bfloat16
                  ) -> Dict[str, torch.Tensor]:
    """x (K, M) (or (M, K)), dz (K, N), w, mu, nu (M, N) with the probes'
    scales, drawn on ``device`` from ``generator`` in float32 and rounded."""
    def normal(shape, scale):
        return torch.randn(shape, device=device, generator=generator).mul_(scale).to(dtype)

    x = normal((K, M), 0.5)
    return {
        "x": x.t().contiguous() if transposed_x else x,
        "dz": normal((K, N), 1e-3),
        "w": normal((M, N), 0.02),
        "mu": normal((M, N), 1e-4),
        "nu": torch.rand((M, N), device=device, generator=generator).mul_(1e-6).to(dtype),
    }


def make_gradient(M: int, N: int, device, generator: torch.Generator,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The given gradient of the epilogue variants: 1e-3 * normal."""
    return torch.randn((M, N), device=device, generator=generator).mul_(1e-3).to(dtype)


@dataclass
class Probe:
    """One variant, ready to step: ``step(count)`` advances ``state`` (the
    tensors a step writes) in place; ``nbytes`` is what it must move once."""

    step: Callable[[int], None]
    state: Tuple[torch.Tensor, ...]
    nbytes: int
    kernel: Optional[str]  # its counter in ops.dense_grad_adam.launches


def build(variant: str, K: int, M: int, N: int, device, generator: torch.Generator,
          operands: Optional[Dict[str, torch.Tensor]] = None) -> Probe:
    """The probe of ``variant`` at (K, M, N). ``operands`` (x, dz, w, mu, nu
    and, for the epilogue variants, g) replace the generated ones; x is (M,
    K) for ``fused_xt``."""
    if variant in TPU_ONLY:
        raise ValueError(f"variant {variant!r} {TPU_ONLY[variant]} and has no counterpart "
                         "on a GPU")
    if variant not in DIAG_VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (expected one of {DIAG_VARIANTS})")
    ops = operands if operands is not None else make_operands(
        K, M, N, device, generator, transposed_x=variant == "fused_xt")
    x, dz, w, mu, nu = (ops[k] for k in ("x", "dz", "w", "mu", "nu"))
    size = w.element_size()
    full = size * (6 * M * N + K * M + K * N)

    if variant == "torch":
        def step(count):
            g = torch.matmul(x.t(), dz)
            dga.adam_epilogue_reference(g, w, mu, nu, count=count, **ADAM)
        return Probe(step, (w, mu, nu), full, None)

    if variant in _FUSED_KW:
        def step(count):
            dga.fused_dense_grad_adam(x, dz, w, mu, nu, count=count, **ADAM,
                                      **_FUSED_KW[variant])
        return Probe(step, (w, mu, nu), full,
                     "fused_xt" if variant == "fused_xt" else "fused")

    if variant == "dot_only":
        g = torch.empty_like(w)
        return Probe(lambda count: dga.dense_grad(x, dz, out=g), (g,),
                     size * (M * N + K * M + K * N), "dense_grad")

    if variant == "copy_only":
        out = tuple(torch.empty_like(t) for t in (w, mu, nu))
        return Probe(lambda count: dga.stream_copy(w, mu, nu, out=out), out,
                     size * 6 * M * N, "stream_copy")

    g = ops["g"] if "g" in ops else make_gradient(M, N, device, generator, w.dtype)
    arithmetic = "bfloat16" if variant == "epi_bf16" else "float32"

    def step(count):
        dga.adam_epilogue_step(g, w, mu, nu, count=count, arithmetic=arithmetic, **ADAM)
    return Probe(step, (w, mu, nu), size * 7 * M * N,
                 "epilogue_bf16" if variant == "epi_bf16" else "epilogue_f32")


def check_fused(variant: str, shape, device, generator: torch.Generator) -> Dict[str, float]:
    """The kernel of a fused variant against the plain version at ``shape``,
    one step with count 5: max |kernel - plain| over max |plain| for w, mu, nu
    (per-element relative error explodes at cancellation zeros; the products'
    sums are taken in another order, which moves a result by about one step
    of its dtype). Raises unless each is below 1/64."""
    K, M, N = shape
    xt = variant == "fused_xt"
    ops = make_operands(K, M, N, device, generator, transposed_x=xt)
    ref = [ops[k].clone() for k in ("w", "mu", "nu")]
    dga.fused_dense_grad_adam(ops["x"], ops["dz"], ops["w"], ops["mu"], ops["nu"], count=5,
                              **ADAM, **_FUSED_KW[variant])
    dga.fused_dense_grad_adam_reference(ops["x"], ops["dz"], *ref, count=5, x_transposed=xt,
                                        **ADAM)
    errs = {}
    for name, got, want in zip(("w", "mu", "nu"), (ops["w"], ops["mu"], ops["nu"]), ref):
        errs[name] = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    if not all(v < 1 / 64 for v in errs.values()):
        raise AssertionError(f"{variant} disagrees with the plain version at {shape}: {errs}")
    return errs


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def run(harness: str, variant: str, *, shape_name: Optional[str] = None,
        shape: Optional[Tuple[int, int, int]] = None, steps: int = 20, check: bool = True,
        device="cuda", seed: int = 0,
        operands: Optional[Dict[str, torch.Tensor]] = None):
    """Run one variant: ``WARMUP`` steps, then ``steps`` timed ones with the
    step count advancing from 1, fenced by ``torch.cuda.synchronize()``.
    Harness ``fused`` takes ``shape_name`` (a key of ``SHAPES``) and, for a
    kernel variant with ``check``, first holds the kernel against the plain
    version at the reduced shape; harness ``diag`` runs at ``DIAG_SHAPE``.
    ``shape`` overrides either. Returns (record, state): the tensors the
    variant wrote, after the last step. On a CPU device the wrappers run the
    plain versions and no device number is recorded."""
    if harness not in ("fused", "diag"):
        raise ValueError(f"harness must be 'fused' or 'diag', got {harness!r}")
    variants = FUSED_VARIANTS if harness == "fused" else DIAG_VARIANTS
    if variant not in variants and variant not in TPU_ONLY:
        raise ValueError(f"harness {harness!r} has no variant {variant!r} (it has {variants})")
    if steps < 1:
        raise ValueError("steps must be at least 1")
    device = torch.device(device)
    cuda = _on_card(device)
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' to run the plain versions)")
    if harness == "fused":
        if shape is None:
            shape = SHAPES[shape_name]
        rec = {"shape": shape_name or "custom", "variant": variant}
    else:
        shape = shape or DIAG_SHAPE
        rec = {"variant": f"diag_{variant}"}
    K, M, N = shape
    rec.update(K=K, M=M, N=N, device=torch.cuda.get_device_name(device) if cuda else "cpu")
    generator = torch.Generator(device=device).manual_seed(seed)
    probe = build(variant, K, M, N, device, generator, operands)
    rec["kernel"] = probe.kernel

    if harness == "fused" and check and variant in _FUSED_KW:
        check_shape = CHECK_SHAPES.get(shape_name, shape)
        rec["max_err_vs_scale"] = check_fused(
            variant, check_shape, device, torch.Generator(device=device).manual_seed(seed + 1))
        rec["check_shape"] = list(check_shape)

    def fence():
        if cuda:
            torch.cuda.synchronize(device)

    count = 1
    for i in range(WARMUP):
        last = i == WARMUP - 1
        if last and cuda:  # what a warm step allocates beyond what is resident
            fence()
            resident = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        probe.step(count)
        count += 1
        if last and cuda:
            fence()
            rec["temp_gb"] = (torch.cuda.max_memory_allocated(device) - resident) / 2 ** 30
    fence()
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        probe.step(count)
        count += 1
    if cuda:
        end.record()
    fence()
    rec["ms"] = (time.perf_counter() - t0) / steps * 1e3
    if cuda:
        rec["event_ms"] = start.elapsed_time(end) / steps
    rec["floor_ms"] = probe.nbytes / HBM_BYTES_PER_S * 1e3
    rec["steps"] = steps
    rec["ts"] = time.time()
    return rec, probe.state
