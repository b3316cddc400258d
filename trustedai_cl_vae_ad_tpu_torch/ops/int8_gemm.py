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

A quantized Dense contracts over chunks that cannot leave int32 (3 for the
flagship's encoder Dense): ``int8_gemm_chunked`` returns each chunk's product
as a slice of one (C, M, N) int32 tensor.

On a CUDA tensor both functions launch one of two hand-written kernels, as
``int8_gemm_arrangement`` picks from dtype, shape and alignment alone:
``csrc/int8_gemm_mma.cu`` (the tensor cores, ``mma.sync`` s8; one launch for
all chunks) or ``csrc/int8_gemm.cu`` (CUDA cores, ``dp4a``; one launch a
chunk). Each source's header says what bounds it and how its design answers.
A launch that fails raises; nothing falls back to the other kernel. On a CPU
tensor they run ``int8_gemm_reference`` / ``int8_gemm_chunked_reference``, the
plain PyTorch versions, which are exact on either device and are what the
kernels are held against on the card, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: launches of the CUDA kernels in this process (the plain version does not count)
launches = 0
#: launches by arrangement (each is also one of ``launches``)
int8_gemm_arrangements = {"mma": 0, "cuda_core": 0}

#: the longest range over which +-127 * +-127 products cannot leave int32
I32_EXACT_K = (1 << 31) // (127 * 127)

#: the grid's y and z limit: the tensor-core kernel's chunk splits and tiles of 32 rows of x
_MAX_GRID_YZ = 65535

_LIB_NAME = "int8_gemm"
_MMA_LIB_NAME = "int8_gemm_mma"
_lib = None
_mma_lib = None


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


def build_mma():
    """Compile (first call) and load the tensor-core kernel; returns the library."""
    global _mma_lib
    if _mma_lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_MMA_LIB_NAME)
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.i8mma_launch.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ll, ll, ll, ll, p]
        lib.i8mma_launch.restype = ctypes.c_int
        lib.i8mma_error_string.argtypes = [ctypes.c_int]
        lib.i8mma_error_string.restype = ctypes.c_char_p
        _mma_lib = lib
    return _mma_lib


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


def int8_gemm_arrangement(x: torch.Tensor, w: torch.Tensor, k0: int = 0,
                          k1: Optional[int] = None, chunk: Optional[int] = None) -> str:
    """Which kernel a product of x (M, K) and w (N, K) over ``[k0, k1)`` in
    chunks of ``chunk`` (default: the whole range) launches on the card, by
    dtype, shape and alignment alone: "mma" (``csrc/int8_gemm_mma.cu``, the
    tensor cores, one launch for all chunks) for int8 operands that start on
    16-byte boundaries with K, k0, k1 and the chunk multiples of 16, at most
    65535 chunks and 65535 tiles of 32 rows of x; "cuda_core"
    (``csrc/int8_gemm.cu``, one launch a chunk) for everything else: views off
    a 16-byte boundary, ranges or chunks that end off a multiple of 16 (the
    tiny models' Dense layers of K = 8). ``i8mma_launch`` refuses exactly what
    this excludes. M = 1 takes the tensor cores too (PERF.md row 10 has both
    arrangements' times there)."""
    k_total = x.shape[1]
    k1 = k_total if k1 is None else int(k1)
    span = k1 - int(k0)
    chunk = span if chunk is None else min(int(chunk), span)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if (x.dtype == torch.int8 and w.dtype == torch.int8 and aligned and k_total % 16 == 0
            and int(k0) % 16 == 0 and k1 % 16 == 0 and chunk > 0 and chunk % 16 == 0
            and -(-span // chunk) <= _MAX_GRID_YZ
            and -(-x.shape[0] // 32) <= _MAX_GRID_YZ):
        return "mma"
    return "cuda_core"


def _launch(arrangement: str, x: torch.Tensor, w: torch.Tensor, k0: int, k1: int,
            chunk: int) -> torch.Tensor:
    """The (C, M, N) chunk products of checked CUDA operands by the named
    arrangement: one launch on "mma", one a chunk on "cuda_core". Counts
    nothing; returns the output."""
    m, n, k_total = x.shape[0], w.shape[0], x.shape[1]
    bounds = [(s, min(s + chunk, k1)) for s in range(k0, k1, chunk)]
    dev = x.device
    out = torch.empty((len(bounds), m, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if arrangement == "mma":
            lib = build_mma()
            error = lib.i8mma_error_string
            rc = lib.i8mma_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k_total,
                                  k0, k1, chunk, stream)
        else:
            lib = build()
            error = lib.int8_gemm_error_string
            for c, (s, e) in enumerate(bounds):
                rc = lib.int8_gemm_launch(x.data_ptr(), w.data_ptr(), out[c].data_ptr(), m, n,
                                          k_total, s, e, stream)
                if rc != 0:
                    break
    if rc != 0:
        raise RuntimeError(f"int8_gemm ({arrangement}) kernel launch failed: "
                           f"{error(rc).decode()}")
    return out


def _int8_gemm_cuda(x: torch.Tensor, w: torch.Tensor, k0: int, k1: int,
                    chunk: int) -> torch.Tensor:
    """Launch the arrangement the rule picks and count its launches."""
    global launches
    arrangement = int8_gemm_arrangement(x, w, k0, k1, chunk)
    out = _launch(arrangement, x, w, k0, k1, chunk)
    count = 1 if arrangement == "mma" else out.shape[0]
    launches += count
    int8_gemm_arrangements[arrangement] += count
    return out


def _chunk_length(chunk: int) -> int:
    if int(chunk) <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return int(chunk)


def int8_gemm(x: torch.Tensor, w: torch.Tensor, k0: int = 0,
              k1: Optional[int] = None) -> torch.Tensor:
    """(M, N) int32 product of x (M, K) and w (N, K) over ``[k0, k1)``
    (default: all of K). Both must be contiguous int8 matrices on one device;
    a view that starts at an address that is not a multiple of 16 is taken
    (by the CUDA-core kernel's slower path). CUDA tensors go through the
    kernel that ``int8_gemm_arrangement`` picks, one launch (or raise); CPU
    tensors through the plain version."""
    k1 = _check(x, w, k0, k1)
    if x.device.type == "cuda":
        return _int8_gemm_cuda(x, w, int(k0), k1, k1 - int(k0))[0]
    if x.device.type != "cpu":
        raise ValueError(f"int8_gemm supports cuda and cpu tensors, got {x.device}")
    return int8_gemm_reference(x, w, k0, k1)


def int8_gemm_chunked_reference(x: torch.Tensor, w: torch.Tensor, chunk: int) -> torch.Tensor:
    """The plain version of ``int8_gemm_chunked``: ``int8_gemm_reference`` over
    each chunk of K, stacked."""
    _check(x, w, 0, None)
    chunk = _chunk_length(chunk)
    k_total = x.shape[1]
    return torch.stack([int8_gemm_reference(x, w, s, min(s + chunk, k_total))
                        for s in range(0, k_total, chunk)])


def int8_gemm_chunked(x: torch.Tensor, w: torch.Tensor, chunk: int) -> torch.Tensor:
    """(C, M, N) int32: slice c is the product of x (M, K) and w (N, K) over
    ``[c chunk, min((c + 1) chunk, K))``, C = ceil(K / chunk). Operands as for
    ``int8_gemm``. CUDA tensors go through the kernel that
    ``int8_gemm_arrangement`` picks: the tensor cores in one launch, the CUDA
    cores in one launch a chunk, each counted in ``launches`` and in
    ``int8_gemm_arrangements`` (or raise); CPU tensors through the plain
    version."""
    _check(x, w, 0, None)
    chunk = _chunk_length(chunk)
    if x.device.type == "cuda":
        return _int8_gemm_cuda(x, w, 0, x.shape[1], chunk)
    if x.device.type != "cpu":
        raise ValueError(f"int8_gemm_chunked supports cuda and cpu tensors, got {x.device}")
    return int8_gemm_chunked_reference(x, w, chunk)
