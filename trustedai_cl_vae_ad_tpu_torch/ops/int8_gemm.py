"""Skinny int8 x int8 -> int32 matrix product over a range of the contraction.

Counterpart of the archived TPU probe ``benchmarks/r4_int8_gemm.py``
(``make_pallas_gemm``), written for the product that int8 serving needs
(``ops/quant.py::_dense`` in ``w8a8`` mode):

    acc[m, n] = sum_{k0 <= k < k1} x[m, k] * w[n, k]

``x`` (M, K) int8 are the quantized activations of M frames, ``w`` (N, K)
int8 is a Dense kernel in the port's (out, in) layout, so both operands are
contiguous along the contraction; the result is (M, N) int32. The sums are
taken modulo 2^32 and read as two's-complement int32: exact for values in
[-127, 127] over a range of at most ``I32_EXACT_K`` = 133144 elements
(127 * 127 * 133144 < 2^31).

On a CUDA tensor ``int8_gemm`` launches the hand-written kernel
``csrc/int8_gemm.cu`` (the source's header says what bounds it and how its
design answers), or raises. On a CPU tensor it runs ``int8_gemm_reference``,
the plain PyTorch version, which is exact on either device and is what the
kernel is held against on the card, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: launches of the CUDA kernel in this process (the plain version does not count)
launches = 0

#: the longest range over which +-127 * +-127 products cannot leave int32
I32_EXACT_K = (1 << 31) // (127 * 127)

_LIB_NAME = "int8_gemm"
_lib = None


def build():
    """Compile (first call) and load the CUDA kernel; returns the library."""
    global _lib
    if _lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_LIB_NAME)
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.int8_gemm_launch.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ll, ll, ll, p]
        lib.int8_gemm_launch.restype = ctypes.c_int
        lib.int8_gemm_error_string.argtypes = [ctypes.c_int]
        lib.int8_gemm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x: torch.Tensor, w: torch.Tensor, k0: int, k1: Optional[int]) -> int:
    """Validate the operands and the range; returns the resolved ``k1``."""
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] == 0 or t.shape[1] == 0:
            raise ValueError(f"{name} must be a non-empty matrix, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (strides {t.stride()})")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"x is (M, K) = {tuple(x.shape)} and w is (N, K) = {tuple(w.shape)}: "
                         "the contraction lengths differ")
    k_total = x.shape[1]
    k1 = k_total if k1 is None else int(k1)
    if not 0 <= int(k0) < k1 <= k_total:
        raise ValueError(f"the range [{k0}, {k1}) is not inside [0, {k_total})")
    if max(x.shape[0], w.shape[0]) >= 1 << 31:
        raise ValueError("more than 2^31 - 1 rows")
    return k1


def int8_gemm_reference(x: torch.Tensor, w: torch.Tensor, k0: int = 0,
                        k1: Optional[int] = None, chunk: int = 1 << 15) -> torch.Tensor:
    """The plain PyTorch version, exact on the CPU and on the card: float64
    products over chunks of the range (an int8 product sum over 32768
    elements stays far below 2^53), added as int64 and wrapped to int32."""
    k1 = _check(x, w, k0, k1)
    total = torch.zeros((x.shape[0], w.shape[0]), dtype=torch.int64, device=x.device)
    for s in range(int(k0), k1, chunk):
        e = min(s + chunk, k1)
        part = x[:, s:e].to(torch.float64) @ w[:, s:e].to(torch.float64).t()
        total += part.to(torch.int64)
    wrapped = torch.remainder(total + (1 << 31), 1 << 32) - (1 << 31)
    return wrapped.to(torch.int32)


def _int8_gemm_cuda(x: torch.Tensor, w: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    global launches
    lib = build()
    dev = x.device
    out = torch.empty((x.shape[0], w.shape[0]), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.int8_gemm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0],
                                  w.shape[0], x.shape[1], int(k0), int(k1), stream)
    if rc != 0:
        raise RuntimeError(
            f"int8_gemm kernel launch failed: {lib.int8_gemm_error_string(rc).decode()}")
    launches += 1
    return out


def int8_gemm(x: torch.Tensor, w: torch.Tensor, k0: int = 0,
              k1: Optional[int] = None) -> torch.Tensor:
    """(M, N) int32 product of x (M, K) and w (N, K) over ``[k0, k1)``
    (default: all of K). Both must be contiguous int8 matrices on one device;
    a view that starts at an address that is not a multiple of 16 is taken
    (by a slower path of the kernel). CUDA tensors go through the kernel (or
    raise); CPU tensors through the plain version."""
    k1 = _check(x, w, k0, k1)
    if x.device.type == "cuda":
        return _int8_gemm_cuda(x, w, k0, k1)
    if x.device.type != "cpu":
        raise ValueError(f"int8_gemm supports cuda and cpu tensors, got {x.device}")
    return int8_gemm_reference(x, w, k0, k1)
