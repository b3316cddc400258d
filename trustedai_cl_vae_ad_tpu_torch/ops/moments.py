"""Latent moments: mean, population variance, skew, kurtosis, of the whole
latent matrix (``global_*``) and of each latent column over the batch
(``perdim_*``).

Counterpart of ``global_moments``, ``perdim_moments`` and their weighted
variants in ``trustedai_cl_vae_ad_tpu/ops/moments.py``, with the same
semantics:

  * population variance (ddof = 0);
  * z_score = divide_no_nan(z - mean, std): skew and kurtosis are 0 where
    std == 0;
  * skew = E[z_score^3], kurtosis = E[z_score^4];
  * the backward is the analytic gradient, not autograd of the forward.

On a CUDA tensor ``global_moments`` and ``perdim_moments`` launch the
hand-written kernels of ``csrc/moments.cu`` (forward and backward; the
source's header says what bounds them and how each reduction is made
repeatable). On a CPU tensor they run the plain PyTorch versions below, which
are also what the kernels are checked against on the card. Neither direction
reads a value back on the host. The weighted variants are plain PyTorch with
autograd on either device, as the JAX package leaves them to autodiff.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

#: forward launches of the global CUDA kernel in this process (plain versions do not count)
launches = 0
#: backward launches of the global CUDA kernel in this process
bwd_launches = 0
#: forward and backward launches of the per-dimension CUDA kernel
perdim_launches = 0
perdim_bwd_launches = 0

_LIB_NAME = "moments"
_lib = None

_THREADS = 256      # kThreads in csrc/moments.cu
_MAX_BLOCKS = 1024  # kMaxBlocks in csrc/moments.cu
_DTYPES = (torch.float32, torch.bfloat16)

Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def build():
    """Compile (first call) and load the CUDA kernels; returns the library."""
    global _lib
    if _lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_LIB_NAME)
        p = ctypes.c_void_p
        lib.moments_global_forward.argtypes = [p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                               p, p, p]
        lib.moments_global_forward.restype = ctypes.c_int
        lib.moments_global_backward.argtypes = [p, ctypes.c_int, ctypes.c_longlong, p, p, p, p]
        lib.moments_global_backward.restype = ctypes.c_int
        ll = ctypes.c_longlong
        lib.moments_perdim_forward.argtypes = [p, ctypes.c_int, ll, ll, p, p]
        lib.moments_perdim_forward.restype = ctypes.c_int
        lib.moments_perdim_backward.argtypes = [p, ctypes.c_int, ll, ll, p, p, p, p]
        lib.moments_perdim_backward.restype = ctypes.c_int
        lib.moments_error_string.argtypes = [ctypes.c_int]
        lib.moments_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """divide_no_nan: 0 where den == 0."""
    den_safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / den_safe)


# -- plain PyTorch versions ------------------------------------------------------

def global_moments_reference(z: torch.Tensor) -> Moments:
    """The plain forward: two passes, z-scores, then their third and fourth
    powers' means (the steps of the JAX package's ``_global_moments_jnp``)."""
    z = z.to(torch.float32)
    n = float(z.numel())
    m = z.sum() / n
    zc = z - m
    var = (zc * zc).sum() / n
    std = torch.sqrt(var)
    zs = _safe_div(zc, std)
    skew = (zs ** 3).sum() / n
    kurt = (zs ** 4).sum() / n
    return m, var, skew, kurt


def global_moments_backward_reference(z: torch.Tensor, moments: torch.Tensor,
                                      gout: torch.Tensor) -> torch.Tensor:
    """The plain analytic backward (the JAX package's ``_global_bwd``, step
    by step). ``moments`` and ``gout`` are (4,) float32: the saved forward
    result and the upstream gradients of (mean, var, skew, kurt)."""
    m, var, skew, kurt = moments.unbind(0)
    gm, gv, gs, gk = gout.unbind(0)
    n = float(z.numel())
    zc = z.to(torch.float32) - m
    std = torch.sqrt(var)
    m2c = var
    m3c = skew * std * var
    m4c = kurt * var * var
    one = torch.ones_like(var)
    inv_var = _safe_div(one, var)
    inv_std3 = _safe_div(one, std * var)
    inv_var2 = inv_var * inv_var
    d_mean = torch.full_like(zc, 1.0 / n)
    d_var = 2.0 * zc / n
    d_skew = (3.0 / n) * inv_std3 * (zc * zc - m2c - m3c * zc * inv_var)
    d_kurt = (4.0 / n) * inv_var2 * (zc * zc * zc - m3c - m4c * zc * inv_var)
    grad = gm * d_mean + gv * d_var + gs * d_skew + gk * d_kurt
    return grad.to(z.dtype)


def perdim_moments_reference(z: torch.Tensor) -> Moments:
    """The plain per-dimension forward over axis 0, each result (L,) (the
    steps of the JAX package's ``_perdim_moments_jnp``)."""
    z = z.to(torch.float32)
    n = float(z.shape[0])
    m = z.sum(dim=0) / n
    zc = z - m[None, :]
    var = (zc * zc).sum(dim=0) / n
    std = torch.sqrt(var)
    zs = _safe_div(zc, std[None, :])
    skew = (zs ** 3).sum(dim=0) / n
    kurt = (zs ** 4).sum(dim=0) / n
    return m, var, skew, kurt


def perdim_moments_backward_reference(z: torch.Tensor, moments: torch.Tensor,
                                      gout: torch.Tensor) -> torch.Tensor:
    """The plain analytic per-dimension backward (the JAX package's
    ``_perdim_bwd``, step by step). ``moments`` and ``gout`` are (4, L)
    float32: the saved forward result and the upstream gradients of the rows
    (mean, var, skew, kurt). Here n is the batch size, not B * L."""
    m, var, skew, kurt = moments.unbind(0)
    gm, gv, gs, gk = gout.unbind(0)
    n = float(z.shape[0])
    zc = z.to(torch.float32) - m[None, :]
    std = torch.sqrt(var)
    m2c = var
    m3c = skew * std * var
    m4c = kurt * var * var
    inv_var = _safe_div(torch.ones_like(var), var)
    inv_std3 = _safe_div(torch.ones_like(var), std * var)
    inv_var2 = inv_var * inv_var
    d_mean = (gm[None, :] / n).expand_as(zc)
    d_var = gv[None, :] * 2.0 * zc / n
    d_skew = gs[None, :] * (3.0 / n) * inv_std3[None, :] * (
        zc * zc - m2c[None, :] - m3c[None, :] * zc * inv_var[None, :])
    d_kurt = gk[None, :] * (4.0 / n) * inv_var2[None, :] * (
        zc * zc * zc - m3c[None, :] - m4c[None, :] * zc * inv_var[None, :])
    grad = d_mean + d_var + d_skew + d_kurt
    return grad.to(z.dtype)


# -- the CUDA kernels ------------------------------------------------------------

def _check_input(z: torch.Tensor) -> None:
    if z.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the moments support cuda and cpu tensors, got {z.device}")
    if z.dtype not in _DTYPES:
        raise TypeError(f"z must be float32 or bfloat16, got {z.dtype}")
    if z.dim() != 2:
        raise ValueError(f"z must be 2-D (batch, latent), got shape {tuple(z.shape)}")
    if z.numel() == 0:
        raise ValueError("z is empty")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")


def forward_blocks(z: torch.Tensor) -> int:
    """Blocks of the forward's two reducing launches: one 16-byte vector per
    thread, capped; a function of the element count and type alone, so the
    order of the sums is the same from run to run."""
    n_vec = z.numel() // (16 // z.element_size())
    return max(1, min(_MAX_BLOCKS, -(-n_vec // _THREADS)))


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"moments kernel {what} launch failed: {_lib.moments_error_string(rc).decode()}")


def _forward_cuda(z: torch.Tensor) -> torch.Tensor:
    global launches
    lib = build()
    blocks = forward_blocks(z)
    partial = torch.empty((4 * blocks,), dtype=torch.float32, device=z.device)
    out = torch.empty((4,), dtype=torch.float32, device=z.device)
    with torch.cuda.device_of(z):
        rc = lib.moments_global_forward(z.data_ptr(), int(z.dtype == torch.bfloat16), z.numel(),
                                        blocks, partial.data_ptr(), out.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "forward")
    launches += 1
    return out


def _check_packed(name: str, t: torch.Tensor, device, shape=(4,)) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {tuple(shape)} tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _backward_cuda(z: torch.Tensor, moments: torch.Tensor, gout: torch.Tensor) -> torch.Tensor:
    global bwd_launches
    lib = build()
    grad = torch.empty_like(z)
    with torch.cuda.device_of(z):
        rc = lib.moments_global_backward(z.data_ptr(), int(z.dtype == torch.bfloat16), z.numel(),
                                         moments.data_ptr(), gout.data_ptr(), grad.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "backward")
    bwd_launches += 1
    return grad


def _perdim_forward_cuda(z: torch.Tensor) -> torch.Tensor:
    global perdim_launches
    lib = build()
    rows, cols = z.shape
    out = torch.empty((4, cols), dtype=torch.float32, device=z.device)
    with torch.cuda.device_of(z):
        rc = lib.moments_perdim_forward(z.data_ptr(), int(z.dtype == torch.bfloat16), rows, cols,
                                        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "per-dimension forward")
    perdim_launches += 1
    return out


def _perdim_backward_cuda(z: torch.Tensor, moments: torch.Tensor,
                          gout: torch.Tensor) -> torch.Tensor:
    global perdim_bwd_launches
    lib = build()
    rows, cols = z.shape
    grad = torch.empty_like(z)
    with torch.cuda.device_of(z):
        rc = lib.moments_perdim_backward(z.data_ptr(), int(z.dtype == torch.bfloat16), rows, cols,
                                         moments.data_ptr(), gout.data_ptr(), grad.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "per-dimension backward")
    perdim_bwd_launches += 1
    return grad


def global_moments_packed(z: torch.Tensor) -> torch.Tensor:
    """The four moments as one (4,) float32 tensor, no autograd: the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    _check_input(z)
    if z.device.type == "cuda":
        return _forward_cuda(z)
    return torch.stack(global_moments_reference(z))


def global_moments_backward(z: torch.Tensor, moments: torch.Tensor,
                            gout: torch.Tensor) -> torch.Tensor:
    """d(sum_k gout[k] * moments[k]) / dz, in z's dtype: the kernel on a CUDA
    tensor, the plain analytic version on a CPU tensor."""
    _check_input(z)
    gout = gout.contiguous()
    _check_packed("moments", moments, z.device)
    _check_packed("gout", gout, z.device)
    if z.device.type == "cuda":
        return _backward_cuda(z, moments, gout)
    return global_moments_backward_reference(z, moments, gout)


class GlobalMoments(torch.autograd.Function):
    """z (B, L) -> (4,) [mean, var, skew, kurt] with the analytic backward."""

    @staticmethod
    def forward(ctx, z: torch.Tensor) -> torch.Tensor:
        out = global_moments_packed(z)
        ctx.save_for_backward(z, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gout: torch.Tensor):
        z, out = ctx.saved_tensors
        return global_moments_backward(z, out, gout.to(torch.float32))


def global_moments(z: torch.Tensor) -> Moments:
    """Global (flattened) moments of z (B, L), float32 or bfloat16 and
    contiguous: (mean, var, skew, kurtosis) as four 0-dim float32 views of
    one device tensor. An output that is not used gets a zero upstream
    gradient (the views' own backward fills it in)."""
    m, var, skew, kurt = GlobalMoments.apply(z).unbind(0)
    return m, var, skew, kurt


def perdim_moments_packed(z: torch.Tensor) -> torch.Tensor:
    """The four per-dimension moments as one (4, L) float32 tensor (rows
    mean, var, skew, kurt), no autograd: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check_input(z)
    if z.device.type == "cuda":
        return _perdim_forward_cuda(z)
    return torch.stack(perdim_moments_reference(z))


def perdim_moments_backward(z: torch.Tensor, moments: torch.Tensor,
                            gout: torch.Tensor) -> torch.Tensor:
    """d(sum_kl gout[k, l] * moments[k, l]) / dz, in z's dtype: the kernel on
    a CUDA tensor, the plain analytic version on a CPU tensor."""
    _check_input(z)
    gout = gout.contiguous()
    _check_packed("moments", moments, z.device, (4, z.shape[1]))
    _check_packed("gout", gout, z.device, (4, z.shape[1]))
    if z.device.type == "cuda":
        return _perdim_backward_cuda(z, moments, gout)
    return perdim_moments_backward_reference(z, moments, gout)


class PerdimMoments(torch.autograd.Function):
    """z (B, L) -> (4, L) [mean; var; skew; kurt] with the analytic backward."""

    @staticmethod
    def forward(ctx, z: torch.Tensor) -> torch.Tensor:
        out = perdim_moments_packed(z)
        ctx.save_for_backward(z, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gout: torch.Tensor):
        z, out = ctx.saved_tensors
        return perdim_moments_backward(z, out, gout.to(torch.float32))


def perdim_moments(z: torch.Tensor) -> Moments:
    """Per-latent-dimension moments of z (B, L) over axis 0, float32 or
    bfloat16 and contiguous: (mean, var, skew, kurtosis), each an (L,)
    float32 row of one device tensor. A row that is not used gets a zero
    upstream gradient (the views' own backward fills it in)."""
    m, var, skew, kurt = PerdimMoments.apply(z).unbind(0)
    return m, var, skew, kurt


def global_moments_weighted(z: torch.Tensor, w: torch.Tensor) -> Moments:
    """Global moments of z's rows weighted by w (B,); weight-0 rows drop out
    of every statistic, and all-ones weights give the unweighted formulas.
    Plain PyTorch with autograd, as the JAX package leaves it to autodiff:
    continual-learning batches are small."""
    z = z.to(torch.float32)
    w = w.to(torch.float32)[:, None]
    n = w.sum() * z.shape[1]
    m = (w * z).sum() / n
    zc = z - m
    var = (w * zc * zc).sum() / n
    std = torch.sqrt(var)
    zs = _safe_div(zc, std)
    zs2 = zs * zs
    skew = (w * zs2 * zs).sum() / n
    kurt = (w * zs2 * zs2).sum() / n
    return m, var, skew, kurt


def perdim_moments_weighted(z: torch.Tensor, w: torch.Tensor) -> Moments:
    """Per-dimension moments over axis 0 with row weights w (B,), each (L,);
    plain PyTorch with autograd, like ``global_moments_weighted``."""
    z = z.to(torch.float32)
    w = w.to(torch.float32)[:, None]
    n = w.sum()
    m = (w * z).sum(dim=0) / n
    zc = z - m[None, :]
    var = (w * zc * zc).sum(dim=0) / n
    std = torch.sqrt(var)
    zs = _safe_div(zc, std[None, :])
    zs2 = zs * zs
    skew = (w * zs2 * zs).sum(dim=0) / n
    kurt = (w * zs2 * zs2).sum(dim=0) / n
    return m, var, skew, kurt
