"""The r18 probe: the weight gradient of the encoder's stride-2 3x3
convolutions by a hand-written kernel, alone and inside the flagship step.

The port's copy of the archived harness ``benchmarks/r18_conv_dw.py``, with
its three modes:

  check        ``ops.conv_dw.conv_dw`` against autograd of the same
               convolution at two small float32 shapes, and both gradients
               through ``conv2d_s2_kernel_dw`` (rtol = atol = 1e-4). On a CPU
               device the wrapper runs its plain version, on the card the
               kernel.
  kernel_only  the kernel alone at the flagship encoder's two convolutions,
               conv1 (B, 224, 300, 3 -> 32) and conv2 (B, 112, 150, 32 -> 64),
               bfloat16 in, float32 out: host clock and CUDA events, fenced,
               beside its bound and, where the caller hands one in, a library
               call that computes the same function.
  bench        the flagship KurtosisGlobal train + score step (bfloat16,
               ``adam_lean``, ``train/bench_step.py::train_score_step``) with
               0, 1 and 2 encoder convolutions routed through the kernel. The
               three variants start from the same seeded weights and see the
               same uint8 batch and latent noise; their losses after one
               update must agree before anything is timed.

Operands come from numpy generators seeded by the caller. A record keeps the
JAX harness's keys (``probe``, ``variant``, ``batch``, ``ms`` or ``fps`` and
``ms_per_step``) and adds the device's name, ``event_ms`` (CUDA events),
``bound_ms`` / ``bound_by`` (each operand read once and the result written
once over an H100's 3.35 TB/s, against 2 * 9 CI CO operations a position at
the card's peak rate for the operands' type), ``library_ms``, and
for ``bench`` the launches of the kernel (and of each of its two arrangements,
``ops.conv_dw.conv_dw_arrangement``), the layers routed and the bytes the
Function had to copy into NHWC order.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trustedai_cl_vae_ad_tpu_torch.models.cvae import Encoder, conv2d_same
from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw
from trustedai_cl_vae_ad_tpu_torch.ops import moments

PROBE = "r18_conv_dw"
#: (B, H, W, CI, CO) of the check
CHECK_SHAPES = [(2, 8, 12, 3, 8), (3, 16, 16, 5, 4)]
CHECK_TOL = 1e-4
#: (H, W, CI, CO) of the flagship encoder's convolutions
FLAGSHIP_SHAPES = {"conv1": (224, 300, 3, 32), "conv2": (112, 150, 32, 64)}
#: label -> number of encoder convolutions routed through the kernel
VARIANTS = (("baseline", 0), ("conv1_kernel_dw", 1), ("conv12_kernel_dw", 2))
#: relative tolerance on the three variants' losses after one update: only two
#: weight gradients differ, by the order of their float32 sums
LOSS_RTOL = 1e-3
# NVIDIA's H100 SXM data sheet: memory rate; dense bfloat16 in the tensor cores, float32 outside
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {2: 989e12, 4: 67e12}  # by the operands' element size
WARMUP = 3


def kernel_bound(batch: int, h: int, w: int, ci: int, co: int, itemsize: int) -> Tuple[float, str]:
    """(bound_ms, bound_by) of one weight gradient: x and dy read once, dW
    written once, against 2 * 9 CI CO operations a position at the peak rate
    of the operands' type."""
    positions = batch * (h // 2) * (w // 2)
    nbytes = itemsize * (batch * h * w * ci + positions * co) + 4 * 9 * ci * co
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * 9 * ci * co * positions / PEAK_FLOP_PER_S[itemsize] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' to run the plain version)")
    return device


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- check ------------------------------------------------------------------------------------

def autograd_gradients(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor):
    """(dx, dW) of sum(conv(x, weight) * dy) by autograd of the port's
    ``conv2d_same``: x, dy NHWC, weight (3, 3, CI, CO)."""
    xx = x.detach().clone().requires_grad_(True)
    ww = weight.detach().clone().requires_grad_(True)
    y = conv2d_same(xx.permute(0, 3, 1, 2), ww.permute(3, 2, 0, 1), None, 2)
    (y.permute(0, 2, 3, 1) * dy).sum().backward()
    return xx.grad, ww.grad


def check_operands(shape, seed: int = 0, rng: Optional[np.random.RandomState] = None):
    """x, weight, dy of the check at (B, H, W, CI, CO), drawn as the JAX
    harness draws them (standard normals; the weight scaled by 0.1)."""
    b, h, w, ci, co = shape
    rng = rng or np.random.RandomState(seed)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((b, h // 2, w // 2, co)).astype(np.float32)
    return x, weight, dy


def check(device="cuda", seed: int = 0) -> List[dict]:
    """Mode ``check``; raises on a disagreement, returns one record a shape."""
    device = _resolve(device)
    rng = np.random.RandomState(seed)
    rows = []
    for shape in CHECK_SHAPES:
        x, weight, dy = (torch.from_numpy(a).to(device) for a in check_operands(shape, rng=rng))
        ref_dx, ref_dw = autograd_gradients(x, weight, dy)
        before = cdw.launches
        got = cdw.conv_dw(x, dy)
        torch.testing.assert_close(got, ref_dw, rtol=CHECK_TOL, atol=CHECK_TOL)
        xx, ww = x.clone().requires_grad_(True), weight.clone().requires_grad_(True)
        (cdw.conv2d_s2_kernel_dw(xx, ww) * dy).sum().backward()
        torch.testing.assert_close(ww.grad, ref_dw, rtol=CHECK_TOL, atol=CHECK_TOL)
        torch.testing.assert_close(xx.grad, ref_dx, rtol=CHECK_TOL, atol=CHECK_TOL)
        _fence(device)
        rows.append({"probe": PROBE, "variant": "check", "shape": list(shape),
                     "max_abs_err": float((got - ref_dw).abs().max()),
                     "launches": cdw.launches - before, "device": _device_name(device)})
    return rows


# -- kernel_only ------------------------------------------------------------------------------

def normal_operand(shape, rng: np.random.Generator, device, dtype) -> torch.Tensor:
    """Standard normals of ``shape`` on ``device``, drawn on the host one
    batch block at a time (the flagship's dy is 413 M values)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, (1 << 24) // int(np.prod(shape[1:])))
    for r0 in range(0, shape[0], rows):
        block = rng.standard_normal((min(rows, shape[0] - r0),) + tuple(shape[1:]),
                                    dtype=np.float32)
        out[r0:r0 + rows] = torch.from_numpy(block).to(device)
    return out


def kernel_only(batch: int = 768, steps: int = 10, device="cuda", seed: int = 0,
                shapes: Optional[Dict[str, Tuple[int, int, int, int]]] = None,
                library: Optional[Callable[[torch.Tensor, torch.Tensor],
                                           Callable[[], torch.Tensor]]] = None) -> List[dict]:
    """Mode ``kernel_only``: one record a shape, bfloat16 operands.
    ``library(x, dy)``, where given, prepares a yardstick and returns the call
    that is timed beside the kernel and held to no tolerance; the port itself
    never calls one."""
    device = _resolve(device)
    cuda = device.type == "cuda"
    rng = np.random.default_rng(seed)
    dtype = torch.bfloat16
    rows = []
    for label, (h, w, ci, co) in (shapes or FLAGSHIP_SHAPES).items():
        x = normal_operand((batch, h, w, ci), rng, device, dtype)
        dy = normal_operand((batch, h // 2, w // 2, co), rng, device, dtype)

        def timed(fn):
            for _ in range(WARMUP):
                out = fn()
            _fence(device)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            for _ in range(steps):
                out = fn()
            if cuda:
                end.record()
            _fence(device)
            ms = (time.perf_counter() - t0) / steps * 1e3
            return out, ms, (start.elapsed_time(end) / steps if cuda else None)

        before = cdw.launches
        out, ms, event_ms = timed(lambda: cdw.conv_dw(x, dy))
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: the weight gradient is not finite")
        bound_ms, bound_by = kernel_bound(batch, h, w, ci, co, x.element_size())
        row = {"probe": PROBE, "variant": f"kernel_only_{label}", "batch": batch,
               "shape": [batch, h, w, ci, co], "dtype": str(dtype)[6:], "ms": ms,
               "event_ms": event_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "launches": cdw.launches - before, "steps": steps,
               "device": _device_name(device)}
        if library is not None:
            _, host_ms, library_event_ms = timed(library(x, dy))
            row["library_ms"] = library_event_ms if cuda else host_ms
        rows.append(row)
        del x, dy, out
    return rows


# -- bench ------------------------------------------------------------------------------------

class ProbeEncoder(Encoder):
    """``models/cvae.py::Encoder`` with the weight gradient of its first
    ``patch_convs`` convolutions taken by ``ops.conv_dw``. It SHARES the base
    encoder's layers (``Conv_i``, ``Dense_j``): the parameters, their names and
    the state dict are the base's, so one checkpoint fits every variant. A
    layer whose input has an odd height or width is not routed (the kernel
    takes even sizes only): it keeps the ordinary convolution. ``routed``
    lists the layers that the last forward did route."""

    def __init__(self, base: Encoder, patch_convs: int):
        nn.Module.__init__(self)
        self.dtype = base.dtype
        self.layers = base.layers
        self.n_conv, self.n_dense = base.n_conv, base.n_dense
        self.patch_convs = int(patch_convs)
        self.routed: List[int] = []

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.to(self.dtype).permute(0, 3, 1, 2)
        self.routed = []
        for i in range(self.n_conv):
            conv = self.layers[f"Conv_{i}"]
            weight, bias = conv.weight.to(self.dtype), conv.bias.to(self.dtype)
            if i < self.patch_convs and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
                # NHWC and HWIO views of the same memory; the bias is added outside
                y = cdw.conv2d_s2_kernel_dw(x.permute(0, 2, 3, 1), weight.permute(2, 3, 1, 0))
                x = y.permute(0, 3, 1, 2) + bias[None, :, None, None]
                self.routed.append(i)
            else:
                x = conv2d_same(x, weight, bias, 2)
            x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for j in range(self.n_dense + 1):
            dense = self.layers[f"Dense_{j}"]
            x = F.linear(x, dense.weight.to(self.dtype), dense.bias.to(self.dtype))
        return x.to(torch.float32)


def patched_encoder(base: Encoder, patch_convs: int) -> Encoder:
    """An encoder that computes what ``base`` computes, on ``base``'s own
    parameters, with its first ``patch_convs`` convolutions' weight gradients
    routed through the kernel."""
    if patch_convs < 0 or patch_convs > base.n_conv:
        raise ValueError(f"patch_convs must be in [0, {base.n_conv}], got {patch_convs}")
    return ProbeEncoder(base, patch_convs)


def bench_config() -> dict:
    """The flagship as the benchmark trains it: bfloat16 with ``adam_lean``."""
    from trustedai_cl_vae_ad_tpu_torch.train.bench_step import flagship_config

    config = flagship_config()
    config["training"]["precision"] = "bfloat16"
    return config


#: the shapes and the model of ``--tiny``: a rehearsal of the harness at a size a CPU takes
TINY_SHAPES = {"conv1": (8, 12, 3, 8), "conv2": (4, 6, 8, 16)}


def tiny_bench_config() -> dict:
    """``bench_config`` cut to 32x48x3, layers [4, 8], latent 8, float32."""
    config = bench_config()
    config["data"]["image_size"] = [32, 48, 3]
    config["model"].update(latent_dimensions=8, layers=[4, 8], decoder_dense_filters=4)
    config["training"]["precision"] = "float32"
    return config


def bench(batch: int = 768, steps: int = 20, warmup: int = WARMUP, device="cuda", seed: int = 0,
          config: Optional[dict] = None, loss_rtol: float = LOSS_RTOL,
          keep_state: bool = False) -> List[dict]:
    """Mode ``bench``: one record a variant. Every variant is built twice from
    seed-0 weights: first for two steps, whose second loss (the loss after one
    update) must agree across the variants within ``loss_rtol`` before
    anything is timed; then for ``warmup`` + ``steps`` timed steps. The model
    is freed between variants. ``keep_state`` adds the first pass's state dict
    (CPU copies) to each record."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.train.bench_step import train_score_step

    device = _resolve(device)
    cuda = device.type == "cuda"
    config = config or bench_config()
    h, w, c = config["data"]["image_size"]
    latent = int(config["model"]["latent_dimensions"])
    x_u8 = torch.from_numpy(
        np.random.RandomState(seed).randint(0, 256, (batch, h, w, c), np.uint8)).to(device)

    def eps(i):  # the latent noise of step i, the same for every variant
        noise = np.random.default_rng([seed, i]).standard_normal((batch, latent),
                                                                 dtype=np.float32)
        return torch.from_numpy(noise).to(device)

    def build(patch):
        model = load_model_from_config(config, seed=0, device=device)
        model.core.encoder = patched_encoder(model.core.encoder, patch)
        model.compile()
        return model

    def release(model):
        del model
        if cuda:
            torch.cuda.empty_cache()

    rows = []
    for label, patch in VARIANTS:
        model = build(patch)
        for i in range(2):
            loss, _ = train_score_step(model, x_u8, 100.0, 10.0, eps=eps(i))
        row = {"probe": PROBE, "variant": label, "batch": batch,
               "routed": list(model.core.encoder.routed), "loss_after_one_step": float(loss)}
        if keep_state:
            row["state"] = {k: v.detach().cpu().clone() for k, v in model.params.items()}
        rows.append(row)
        release(model)
    losses = [r["loss_after_one_step"] for r in rows]
    if not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"a variant's loss is not finite: {losses}")
    spread = max(losses) - min(losses)
    if spread > loss_rtol * abs(losses[0]):
        raise AssertionError(f"the variants' losses after one step disagree: {losses} "
                             f"(allowed {loss_rtol:g} relative)")

    for row, (label, patch) in zip(rows, VARIANTS):
        model = build(patch)
        counts = (cdw.launches, moments.launches, moments.bwd_launches, cdw.copied_bytes)
        arrangements = dict(cdw.conv_dw_arrangements)
        for i in range(warmup):
            loss, z = train_score_step(model, x_u8, 100.0, 10.0, eps=eps(2 + i))
        _fence(device)
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for i in range(steps):
            loss, z = train_score_step(model, x_u8, 100.0, 10.0, eps=eps(2 + warmup + i))
        if cuda:
            end.record()
        _fence(device)
        dt = time.perf_counter() - t0
        last = float(loss)
        if not (np.isfinite(last) and bool(torch.isfinite(z).all()) and z.shape == (batch,)):
            raise AssertionError(f"{label}: loss {last} or the z-scores are not finite")
        row.update(fps=batch * steps / dt, ms_per_step=1e3 * dt / steps,
                   event_ms=start.elapsed_time(end) / steps if cuda else None,
                   last_loss=last, steps=steps, warmup=warmup,
                   launches=cdw.launches - counts[0],
                   arrangements={k: v - arrangements[k]
                                 for k, v in cdw.conv_dw_arrangements.items()},
                   moments_launches=[moments.launches - counts[1],
                                     moments.bwd_launches - counts[2]],
                   copied_bytes_per_step=(cdw.copied_bytes - counts[3]) // (warmup + steps),
                   device=_device_name(device))
        release(model)
    return rows
