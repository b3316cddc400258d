"""Weight gradient of a 3x3, stride-2, SAME convolution on even H and W, and
the convolution that routes its weight gradient through it.

Counterpart of the archived TPU probe ``benchmarks/r18_conv_dw.py``
(``conv_dw_pallas`` and the ``custom_vjp`` ``conv2d_s2_pallas_dw``):

    dW[kh, kw, ci, co] = sum_{b, oh, ow} xpad[b, 2 oh + kh, 2 ow + kw, ci] * dy[b, oh, ow, co]

with ``xpad`` = x padded by one row of zeros below and one column of zeros to
the right (TF's SAME padding for k = 3, s = 2 on even sizes), and the sums
taken in float32. The public functions keep the JAX layout: x (B, H, W, CI) and
dy (B, H/2, W/2, CO) are NHWC, bfloat16 or float32, both alike; the result is
(3, 3, CI, CO) float32, HWIO. ``dw_to_oihw`` maps it onto the gradient of an
``nn.Conv2d.weight`` (the bridge's HWIO -> OIHW map).

On a CUDA tensor ``conv_dw`` launches one of two hand-written kernels, as
``conv_dw_arrangement`` picks from dtype, shape and alignment alone:
``csrc/conv_dw_wgmma.cu`` (the tensor cores) for bfloat16 with channel counts
that are multiples of 8 on 16-byte boundaries, ``csrc/conv_dw.cu`` (CUDA
cores) for everything else (each source's header says what bounds it and
what its design does about that); a launch that fails raises, nothing falls
back to the other kernel. On a CPU tensor it runs ``conv_dw_reference``, the
plain PyTorch version of the same arithmetic, which the kernels are held
against on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: launches of the CUDA kernels in this process (the plain version does not count)
launches = 0
#: launches by arrangement (each is also one of ``launches``)
conv_dw_arrangements = {"wgmma": 0, "cuda_core": 0}
#: bytes that ``Conv2dS2KernelDW.backward`` copied to hand the kernel NHWC-contiguous operands
copied_bytes = 0

_LIB_NAME = "conv_dw"
_WGMMA_LIB_NAME = "conv_dw_wgmma"
_lib = None
_wgmma_lib = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build():
    """Compile (first call) and load the CUDA kernel; returns the library."""
    global _lib
    if _lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_LIB_NAME)
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.conv_dw_splits.argtypes = [i, ll, ll, ll, ll, ll]
        lib.conv_dw_splits.restype = ll
        lib.conv_dw_launch.argtypes = [p, p, p, p, ll, i, ll, ll, ll, ll, ll, p]
        lib.conv_dw_launch.restype = i
        lib.conv_dw_error_string.argtypes = [i]
        lib.conv_dw_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_wgmma():
    """Compile (first call) and load the tensor-core kernel; returns the library."""
    global _wgmma_lib
    if _wgmma_lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_WGMMA_LIB_NAME)
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.cdw_wgmma_splits.argtypes = [ll, ll, ll, ll, ll]
        lib.cdw_wgmma_splits.restype = ll
        lib.cdw_wgmma_launch.argtypes = [p, p, p, p, ll, ll, ll, ll, ll, ll, p]
        lib.cdw_wgmma_launch.restype = i
        lib.cdw_wgmma_error_string.argtypes = [i]
        lib.cdw_wgmma_error_string.restype = ctypes.c_char_p
        _wgmma_lib = lib
    return _wgmma_lib


def _check(x: torch.Tensor, dy: torch.Tensor) -> None:
    """Raise on operands the function does not take."""
    for name, t in (("x", x), ("dy", dy)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dim() != 4 or 0 in t.shape:
            raise ValueError(f"{name} must be a non-empty NHWC tensor, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous in NHWC order (strides {t.stride()})")
    if dy.dtype != x.dtype:
        raise TypeError(f"x is {x.dtype} and dy is {dy.dtype}: both must have one dtype")
    if dy.device != x.device:
        raise ValueError(f"dy is on {dy.device}, x on {x.device}")
    b, h, w, _ = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"H and W must be even, got x of shape {tuple(x.shape)}")
    if tuple(dy.shape[:3]) != (b, h // 2, w // 2):
        raise ValueError(f"dy of shape {tuple(dy.shape)} does not belong to x of shape "
                         f"{tuple(x.shape)}: expected ({b}, {h // 2}, {w // 2}, CO)")


def conv_dw_reference(x: torch.Tensor, dy: torch.Tensor,
                      accumulate: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version: pad, nine strided slices of the padded x,
    each contracted with dy over batch and positions in float32 (or in
    ``accumulate``: float64 gives the reference both are held against)."""
    _check(x, dy)
    oh, ow = dy.shape[1], dy.shape[2]
    xpad = F.pad(x.to(accumulate), (0, 0, 0, 1, 0, 1))
    dy_rows = dy.to(accumulate).reshape(-1, dy.shape[3])
    taps = []
    for kh in range(3):
        for kw in range(3):
            tap = xpad[:, kh:kh + 2 * oh:2, kw:kw + 2 * ow:2, :]
            taps.append(tap.reshape(-1, x.shape[3]).t() @ dy_rows)
    return torch.stack(taps).reshape(3, 3, x.shape[3], dy.shape[3])


def _shape_fits(b: int, h: int, w: int, ci: int, co: int) -> bool:
    """The tensor-core kernel's limits on the shapes: every count an int, the
    positions B H/2 W/2 below 2^31 (a block counts its share of them in
    ints), and the CUDA-core kernel's limits on the rest."""
    lim, big = 1 << 31, 1 << 40
    return (b < lim and h < lim and w < 1 << 30 and ci < 1 << 20 and co < 1 << 20
            and b * (h // 2) * (w // 2) < lim and 9 * ci * co < lim
            and b * h * w < big // ci and b * h * w < big // co)


def conv_dw_arrangement(x: torch.Tensor, dy: torch.Tensor) -> str:
    """Which kernel ``conv_dw`` launches for these operands on the card, by
    dtype, shape and alignment alone: "wgmma" (``csrc/conv_dw_wgmma.cu``, the
    tensor cores) for bfloat16 with CI and CO multiples of 8, x and dy starting
    on 16-byte boundaries, and the shapes within the kernel's counts (fewer
    than 2^31 output positions); "cuda_core" (``csrc/conv_dw.cu``) for
    everything else: float32, CI = 3, ragged channel counts, views off a
    16-byte boundary, counts past the kernel's ints. ``cdw_wgmma_launch``
    refuses exactly what this excludes."""
    b, h, w, ci = x.shape
    co = dy.shape[3]
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    if (x.dtype == torch.bfloat16 and dy.dtype == torch.bfloat16 and ci % 8 == 0
            and co % 8 == 0 and aligned and _shape_fits(b, h, w, ci, co)):
        return "wgmma"
    return "cuda_core"


def _launch(arrangement: str, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """One launch of the named arrangement on checked CUDA operands; returns
    dW. Counts nothing."""
    wgmma = arrangement == "wgmma"
    lib = build_wgmma() if wgmma else build()
    error = lib.cdw_wgmma_error_string if wgmma else lib.conv_dw_error_string
    dev = x.device
    b, h, w, ci = x.shape
    co = dy.shape[3]
    code = _DTYPE_CODES[x.dtype]
    with torch.cuda.device(dev):
        splits = (lib.cdw_wgmma_splits(b, h, w, ci, co) if wgmma
                  else lib.conv_dw_splits(code, b, h, w, ci, co))
        if splits <= 0:
            raise RuntimeError(f"conv_dw ({arrangement}) cannot plan a launch for x of shape "
                               f"{tuple(x.shape)}: {error(-splits).decode()}")
        # every element of both is written by the launch
        scratch = torch.empty(splits * 9 * ci * co, dtype=torch.float32, device=dev)
        out = torch.empty((3, 3, ci, co), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if wgmma:
            rc = lib.cdw_wgmma_launch(x.data_ptr(), dy.data_ptr(), out.data_ptr(),
                                      scratch.data_ptr(), scratch.numel(), b, h, w, ci, co,
                                      stream)
        else:
            rc = lib.conv_dw_launch(x.data_ptr(), dy.data_ptr(), out.data_ptr(),
                                    scratch.data_ptr(), scratch.numel(), code, b, h, w, ci, co,
                                    stream)
    if rc != 0:
        raise RuntimeError(f"conv_dw ({arrangement}) kernel launch failed: {error(rc).decode()}")
    return out


def conv_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(3, 3, CI, CO) float32 weight gradient of the 3x3, stride-2, SAME
    convolution of x (B, H, W, CI) whose output gradient is dy (B, H/2, W/2,
    CO). Both are contiguous NHWC tensors of one dtype (float32 or bfloat16)
    on one device, H and W even; a view that starts at an address that is not
    a multiple of 16 is taken. CUDA tensors go through the kernel that
    ``conv_dw_arrangement`` picks (or raise), each launch counted in
    ``launches`` and in ``conv_dw_arrangements``; CPU tensors through the
    plain version."""
    global launches
    _check(x, dy)
    if x.device.type == "cuda":
        arrangement = conv_dw_arrangement(x, dy)
        out = _launch(arrangement, x, dy)
        launches += 1
        conv_dw_arrangements[arrangement] += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"conv_dw supports cuda and cpu tensors, got {x.device}")
    return conv_dw_reference(x, dy)


def dw_to_oihw(dw: torch.Tensor) -> torch.Tensor:
    """(kh, kw, CI, CO) -> (CO, CI, kh, kw): the layout of ``nn.Conv2d.weight``."""
    return dw.permute(3, 2, 0, 1)


def _nhwc_contiguous(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads NHWC memory: an operand that arrives in another order
    (the library chooses the order of its outputs and gradients) is copied,
    and the copy is counted in ``copied_bytes``."""
    global copied_bytes
    if t.is_contiguous():
        return t
    copied_bytes += t.numel() * t.element_size()
    return t.contiguous()


class Conv2dS2KernelDW(torch.autograd.Function):
    """``conv2d_s2_kernel_dw`` as an autograd Function: forward and the data
    gradient by the library's convolution, the weight gradient by ``conv_dw``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[:2]) != (3, 3) \
                or weight.shape[2] != x.shape[3]:
            raise ValueError(f"expected x (B, H, W, CI) and weight (3, 3, CI, CO), got "
                             f"{tuple(x.shape)} and {tuple(weight.shape)}")
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(f"H and W must be even, got x of shape {tuple(x.shape)}")
        if weight.dtype != x.dtype:
            raise TypeError(f"x is {x.dtype} and weight is {weight.dtype}")
        ctx.save_for_backward(x, weight)
        # TF SAME padding of k = 3, s = 2 on even sizes: one row below, one column right
        xpad = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
        y = F.conv2d(xpad, dw_to_oihw(weight), stride=2)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, weight = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            b, h, w, ci = x.shape
            dx_pad = torch.nn.grad.conv2d_input((b, ci, h + 1, w + 1), dw_to_oihw(weight),
                                                dy.permute(0, 3, 1, 2), stride=2)
            dx = dx_pad[:, :, :h, :w].permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = conv_dw(_nhwc_contiguous(x), _nhwc_contiguous(dy)).to(weight.dtype)
        return dx, dw


def conv2d_s2_kernel_dw(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """3x3, stride-2, SAME convolution without bias whose weight gradient is
    taken by ``conv_dw`` (the counterpart of ``conv2d_s2_pallas_dw``).

    Layouts are the JAX function's: x (B, H, W, CI) NHWC with even H and W,
    weight (3, 3, CI, CO) HWIO, both of one dtype (float32 or bfloat16);
    returns (B, H/2, W/2, CO) NHWC, as a view of the library's output in
    whatever memory order it chose. The gradient of x has x's shape, the
    gradient of weight is (3, 3, CI, CO) in weight's dtype. A caller that holds
    NCHW activations and an ``nn.Conv2d.weight`` passes permuted views
    (``x.permute(0, 2, 3, 1)``, ``weight.permute(2, 3, 1, 0)``): autograd maps
    the gradients back. The bias is added outside."""
    return Conv2dS2KernelDW.apply(x, weight)
