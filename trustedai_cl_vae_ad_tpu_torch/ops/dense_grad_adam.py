"""One Adam step on a dense kernel with the gradient product fused in, and
the pieces the step is made of.

Counterpart of the archived TPU probes ``benchmarks/r11_kernel.py``
(``fused_dense_grad_adam``) and ``benchmarks/r11_diag.py`` (``fused_xt``,
``dot_only``, ``copy_only``, ``epi_bf16``, ``epi_only``). The public layout is
the JAX one: ``w``, ``mu``, ``nu`` are (M, N) = (in, out), ``x`` (K, M) holds
the layer's inputs of K rows and ``dz`` (K, N) the gradient of its outputs.

    g    = round_to(w.dtype, x^T . dz)              float32 accumulation
    mu'  = b1 * mu + (1 - b1) * g                   float32; 1 - b1 a float32 difference
    nu'  = b2 * nu + (1 - b2) * (g * g)
    upd  = lr * (mu' / bc1) / (sqrt(nu' / bc2) + eps)     left to right, eps outside the root
    w'   = round_to(w.dtype, w - upd);  mu', nu' rounded to their dtype
    bc_i = 1 - b_i ** count  in float32, count the number of the step taken (1 for the first)

This is not the arithmetic of ``ops/adam.py`` (which follows optax and runs
mu's average in the gradient's dtype); nothing in the training step calls it.

The JAX functions are pure and their callers donate the state; here **w, mu
and nu are updated in place and the same tensors are returned**.

The port's own ``nn.Linear`` weight is (out, in). Its update is the same
function with the operands swapped: ``fused_dense_grad_adam(x=dz, dz=x, w=W,
...)`` contracts the same K rows and gives the (N, M) update.

On CUDA tensors every function launches its hand-written kernel from
``csrc/dense_grad_adam.cu``, or, for bf16 operands on the tensor cores' rule,
the product alone from ``csrc/dense_grad_wgmma.cu`` and the product with the
step from ``csrc/dense_grad_adam_wgmma.cu`` (each source's header says what
bounds its kernels and what their design does about it), or raises. On CPU
tensors it runs the plain PyTorch version beside it (``*_reference``), which is what the kernels are
held against on the card: the streaming kernels bit for bit, the products
within the order of their sums.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

#: launches of each CUDA kernel in this process (the plain versions do not count)
launches: Dict[str, int] = {"fused": 0, "fused_xt": 0, "dense_grad": 0, "stream_copy": 0,
                            "epilogue_bf16": 0, "epilogue_f32": 0}
#: launches of ``dense_grad`` by arrangement (each is also one of launches["dense_grad"])
dense_grad_arrangements: Dict[str, int] = {"wgmma": 0, "cuda_core": 0}
#: launches of ``fused_dense_grad_adam`` by arrangement (each is also one of
#: launches["fused"] or launches["fused_xt"])
fused_arrangements: Dict[str, int] = {"wgmma": 0, "cuda_core": 0}

ARITHMETICS = ("float32", "bfloat16")
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_LIB_NAME = "dense_grad_adam"
_WGMMA_LIB_NAME = "dense_grad_wgmma"
_FUSED_WGMMA_LIB_NAME = "dense_grad_adam_wgmma"
_lib = None
_wgmma_lib = None
_fused_wgmma_lib = None

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def build():
    """Compile (first call) and load the CUDA kernels; returns the library."""
    global _lib
    if _lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_LIB_NAME)
        p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.dga_tile_launch.argtypes = [p, p, p, p, p, ll, ll, ll, i, i, i,
                                        f, f, f, f, f, f, p]
        lib.dga_epilogue_launch.argtypes = [p, p, p, p, ll, i, i, f, f, f, f, f, f, p]
        lib.dga_copy_launch.argtypes = [p, p, p, p, p, p, ll, p]
        for fn in (lib.dga_tile_launch, lib.dga_epilogue_launch, lib.dga_copy_launch):
            fn.restype = ctypes.c_int
        lib.dga_error_string.argtypes = [ctypes.c_int]
        lib.dga_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_wgmma():
    """Compile (first call) and load the tensor-core product; returns the library."""
    global _wgmma_lib
    if _wgmma_lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_WGMMA_LIB_NAME)
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.dgw_launch.argtypes = [p, p, p, ll, ll, ll, p]
        lib.dgw_launch.restype = ctypes.c_int
        lib.dgw_error_string.argtypes = [ctypes.c_int]
        lib.dgw_error_string.restype = ctypes.c_char_p
        _wgmma_lib = lib
    return _wgmma_lib


def build_fused_wgmma():
    """Compile (first call) and load the tensor-core product with the step; returns the
    library."""
    global _fused_wgmma_lib
    if _fused_wgmma_lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_FUSED_WGMMA_LIB_NAME)
        p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.dgaw_launch.argtypes = [p, p, p, p, p, ll, ll, ll, i, i, f, f, f, f, f, f, p]
        lib.dgaw_launch.restype = ctypes.c_int
        lib.dgaw_error_string.argtypes = [ctypes.c_int]
        lib.dgaw_error_string.restype = ctypes.c_char_p
        _fused_wgmma_lib = lib
    return _fused_wgmma_lib


# -- the six scalars -------------------------------------------------------------

def adam_scalars(lr: float, b1: float, b2: float, eps: float, count: int
                 ) -> Tuple[float, float, float, float, float, float]:
    """(lr, b1, b2, eps, 1 - b1**count, 1 - b2**count), each rounded to
    float32 and the powers taken in float32 (as ``ops/adam.py`` takes them),
    returned as Python floats that a float32 holds exactly. ``count`` is the
    number of the step being taken, 1 for the first."""
    count = int(count)
    if count < 1:
        raise ValueError(f"count is the number of the step being taken (>= 1), got {count}")
    f32 = [torch.tensor(float(v), dtype=torch.float32) for v in (lr, b1, b2, eps)]
    bc1 = 1.0 - f32[1] ** count
    bc2 = 1.0 - f32[2] ** count
    return tuple(float(v) for v in (*f32, bc1, bc2))


# -- checks ----------------------------------------------------------------------

def _check_matrix(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device,
                  shape: Optional[Tuple[int, int]] = None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype} (all operands share one dtype)")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != 2 or t.numel() == 0:
        raise ValueError(f"{name} must be a non-empty matrix, got shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (strides {t.stride()})")


def _check_dtype_device(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what} must be bfloat16 or float32, got {t.dtype}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} must be a cuda or cpu tensor, got {t.device}")


def _span(t: torch.Tensor) -> Tuple[int, int]:
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


def _check_disjoint(written: Sequence[Tuple[str, torch.Tensor]],
                    read: Sequence[Tuple[str, torch.Tensor]] = ()) -> None:
    """No written tensor may share memory with another written or a read one:
    every element is read and written by one thread, once."""
    for i, (name_a, a) in enumerate(written):
        for name_b, b in (*written[i + 1:], *read):
            (a0, a1), (b0, b1) = _span(a), _span(b)
            if a0 < b1 and b0 < a1:
                raise ValueError(f"{name_a} and {name_b} overlap in memory")


def _check_state(w: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor) -> None:
    _check_dtype_device(w, "w")
    _check_matrix("w", w, w.dtype, w.device)
    _check_matrix("mu", mu, w.dtype, w.device, tuple(w.shape))
    _check_matrix("nu", nu, w.dtype, w.device, tuple(w.shape))


def _check_product(x: torch.Tensor, dz: torch.Tensor, x_transposed: bool) -> Tuple[int, int, int]:
    """Validate x and dz; returns (K, M, N)."""
    _check_dtype_device(x, "x")
    _check_matrix("x", x, x.dtype, x.device)
    _check_matrix("dz", dz, x.dtype, x.device)
    m, k = x.shape if x_transposed else x.shape[::-1]
    if dz.shape[0] != k:
        raise ValueError(f"x is {'(M, K)' if x_transposed else '(K, M)'} = {tuple(x.shape)} and "
                         f"dz is (K, N) = {tuple(dz.shape)}: the contraction lengths differ")
    if k >= 1 << 31:
        raise ValueError("a contraction over more than 2^31 - 1 rows")
    return int(k), int(m), int(dz.shape[1])


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: {_lib.dga_error_string(rc).decode()}")


def _raise_on_wgmma(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"dense_grad (wgmma) kernel launch failed: {_wgmma_lib.dgw_error_string(rc).decode()}")


def _raise_on_fused_wgmma(rc: int) -> None:
    if rc != 0:
        raise RuntimeError("fused_dense_grad_adam (wgmma) kernel launch failed: "
                           f"{_fused_wgmma_lib.dgaw_error_string(rc).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- the Adam epilogue on a given gradient (rows 8 and 9) ---------------------------

def _device_scalars(values, dtype, device):
    return [torch.tensor(v, dtype=torch.float32).to(dtype).to(device) for v in values]


@torch.no_grad()
def adam_epilogue_reference(g: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
                            nu: torch.Tensor, *, lr: float, b1: float = 0.9, b2: float = 0.999,
                            eps: float = 1e-8, count: int) -> State:
    """The plain float32 step, in place: ``adam_epilogue`` of
    ``benchmarks/r11_kernel.py``, one PyTorch operation for each of its
    operations, in its order. ``g`` is float32 or of w's dtype; it is rounded
    to w's dtype first. The scalars are 0-dim tensors on the device, so that
    each division is a division (a Python divisor becomes a multiplication by
    its reciprocal on the card)."""
    lr_, b1_, b2_, eps_, bc1, bc2 = _device_scalars(
        adam_scalars(lr, b1, b2, eps, count), torch.float32, w.device)
    one = torch.ones((), dtype=torch.float32, device=w.device)
    gf = g.to(w.dtype).float()
    mu_n = b1_ * mu.float() + (one - b1_) * gf
    nu_n = b2_ * nu.float() + (one - b2_) * (gf * gf)
    upd = lr_ * (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + eps_)
    w.copy_(w.float() - upd)
    mu.copy_(mu_n)
    nu.copy_(nu_n)
    return w, mu, nu


@torch.no_grad()
def adam_epilogue_bf16_reference(g: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
                                 nu: torch.Tensor, *, lr: float, b1: float = 0.9,
                                 b2: float = 0.999, eps: float = 1e-8, count: int) -> State:
    """The plain version of ``epi_bf16``, in place: the six scalars cast to
    bfloat16 and every product, sum, quotient and root rounded to bfloat16.
    Numerically wrong on purpose (b2 = 0.999 rounds to 1, so nu stays): the
    TPU probe isolates the cost of the casts with it."""
    lr_, b1_, b2_, eps_, bc1, bc2 = _device_scalars(
        adam_scalars(lr, b1, b2, eps, count), torch.bfloat16, w.device)
    one = torch.ones((), dtype=torch.bfloat16, device=w.device)
    mu_n = b1_ * mu + (one - b1_) * g
    nu_n = b2_ * nu + (one - b2_) * (g * g)
    upd = lr_ * (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + eps_)
    w.copy_(w - upd)
    mu.copy_(mu_n)
    nu.copy_(nu_n)
    return w, mu, nu


def adam_epilogue_step(g: torch.Tensor, w: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, *,
                       lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                       count: int, arithmetic: str = "float32") -> State:
    """One Adam step on w, mu, nu (M, N) from a given gradient ``g`` (M, N) of
    the same dtype, in place; returns (w, mu, nu), the same tensors.
    ``arithmetic`` "float32" is ``epi_only`` (the step of the module's
    docstring), "bfloat16" is ``epi_bf16`` (bfloat16 tensors only). One pass:
    g, w, mu, nu read once, w, mu, nu written once."""
    if arithmetic not in ARITHMETICS:
        raise ValueError(f"arithmetic must be one of {ARITHMETICS}, got {arithmetic!r}")
    _check_state(w, mu, nu)
    _check_matrix("g", g, w.dtype, w.device, tuple(w.shape))
    _check_disjoint([("w", w), ("mu", mu), ("nu", nu)], [("g", g)])
    bf16 = arithmetic == "bfloat16"
    if bf16 and w.dtype != torch.bfloat16:
        raise TypeError(f"bfloat16 arithmetic takes bfloat16 tensors, got {w.dtype}")
    scalars = adam_scalars(lr, b1, b2, eps, count)
    if w.device.type == "cpu":
        reference = adam_epilogue_bf16_reference if bf16 else adam_epilogue_reference
        return reference(g, w, mu, nu, lr=lr, b1=b1, b2=b2, eps=eps, count=count)
    lib = build()
    with torch.cuda.device(w.device):
        rc = lib.dga_epilogue_launch(g.data_ptr(), w.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                                     w.numel(), _DTYPES[w.dtype], int(bf16), *scalars,
                                     _stream(w))
    _raise_on(rc, "adam_epilogue_step")
    launches["epilogue_bf16" if bf16 else "epilogue_f32"] += 1
    return w, mu, nu


# -- the gradient product alone (row 6) ---------------------------------------------

@torch.no_grad()
def dense_grad_reference(x: torch.Tensor, dz: torch.Tensor,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain product: x^T . dz in float32, rounded once to x's dtype."""
    g = (x.float().t() @ dz.float()).to(x.dtype)
    return g if out is None else out.copy_(g)


def dense_grad_arrangement(x: torch.Tensor, dz: torch.Tensor, out: torch.Tensor) -> str:
    """Which kernel ``dense_grad`` launches for these operands on the card, by
    dtype, shape and alignment alone: "wgmma" (``csrc/dense_grad_wgmma.cu``,
    the tensor cores) for bfloat16 with M and N multiples of 8, x, dz, out
    starting on 16-byte boundaries, and K's stages of 64 rows and the 128 x 128
    tiles each fewer than 2^31 (the kernel's int counts); "cuda_core"
    (``tile_kernel`` of ``csrc/dense_grad_adam.cu``) for everything else:
    float32, ragged M or N, views off a 16-byte boundary, counts past an int."""
    (k, m), n = x.shape, dz.shape[1]
    return "wgmma" if _on_the_wgmma_rule(x.dtype, k, m, n, (x, dz, out)) else "cuda_core"


def _on_the_wgmma_rule(dtype: torch.dtype, k: int, m: int, n: int,
                       tensors: Sequence[torch.Tensor]) -> bool:
    """The tensor-core kernels' shared rule (``dgw_launch``'s and ``dgaw_launch``'s
    refusals): bfloat16, M and N multiples of 8, every tensor on a 16-byte
    boundary, K's stages of 64 rows and the 128 x 128 tiles each below 2^31."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    counts_fit = -(-k // 64) < 2**31 and -(-m // 128) * -(-n // 128) < 2**31
    return dtype == torch.bfloat16 and m % 8 == 0 and n % 8 == 0 and aligned and counts_fit


def dense_grad(x: torch.Tensor, dz: torch.Tensor, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """g (M, N) = x^T . dz for x (K, M) and dz (K, N), summed in float32 and
    written in the operands' dtype (``dot_only``). ``out`` is written and
    returned when given, else a new tensor.

    On the card the kernel is chosen by ``dense_grad_arrangement``: bfloat16
    with M % 8 == 0, N % 8 == 0, x, dz, out 16-byte aligned and K's stages
    and the tiles fewer than 2^31 each runs on the tensor cores (wgmma),
    anything else on CUDA cores. The choice is never
    made on failure: a launch that fails raises. Each launch counts in
    ``launches["dense_grad"]`` and in ``dense_grad_arrangements``."""
    _, m, n = _check_product(x, dz, x_transposed=False)
    if out is not None:
        _check_matrix("out", out, x.dtype, x.device, (m, n))
        _check_disjoint([("out", out)], [("x", x), ("dz", dz)])
    if x.device.type == "cpu":
        return dense_grad_reference(x, dz, out)
    if out is None:
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    arrangement = dense_grad_arrangement(x, dz, out)
    _launch_dense_grad(arrangement, x, dz, out)
    launches["dense_grad"] += 1
    dense_grad_arrangements[arrangement] += 1
    return out


def _launch_dense_grad(arrangement: str, x: torch.Tensor, dz: torch.Tensor,
                       out: torch.Tensor) -> None:
    """One launch of the named arrangement on checked CUDA operands; counts
    nothing (``dense_grad`` counts). The tensor-core kernel refuses what its
    rule excludes, with an error."""
    (k, m), n = x.shape, dz.shape[1]
    if arrangement == "wgmma":
        lib = build_wgmma()
        with torch.cuda.device(x.device):
            rc = lib.dgw_launch(x.data_ptr(), dz.data_ptr(), out.data_ptr(), k, m, n, _stream(x))
        _raise_on_wgmma(rc)
        return
    lib = build()
    with torch.cuda.device(x.device):
        rc = lib.dga_tile_launch(x.data_ptr(), dz.data_ptr(), out.data_ptr(), None, None,
                                 k, m, n, _DTYPES[x.dtype], 0, 0,
                                 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, _stream(x))
    _raise_on(rc, "dense_grad")


# -- the product with the step in its epilogue (rows 4 and 5) -----------------------

@torch.no_grad()
def fused_dense_grad_adam_reference(x: torch.Tensor, dz: torch.Tensor, w: torch.Tensor,
                                    mu: torch.Tensor, nu: torch.Tensor, *, lr: float,
                                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                                    count: int, x_transposed: bool = False) -> State:
    """The plain version, in place: the float32 product, then
    ``adam_epilogue_reference`` (which rounds it to w's dtype first)."""
    xf = x.float()
    g32 = (xf if x_transposed else xf.t()) @ dz.float()
    return adam_epilogue_reference(g32, w, mu, nu, lr=lr, b1=b1, b2=b2, eps=eps, count=count)


def fused_arrangement(x: torch.Tensor, dz: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
                      nu: torch.Tensor, x_transposed: bool = False) -> str:
    """Which kernel ``fused_dense_grad_adam`` launches for these operands on
    the card, by dtype, shape and alignment alone: "wgmma"
    (``csrc/dense_grad_adam_wgmma.cu``, the tensor cores) for bfloat16 with M
    and N multiples of 8 (and K too when x is (M, K)), all five tensors
    starting on 16-byte boundaries, and K's stages of 64 rows and the 128 x 128
    tiles each fewer than 2^31 (the kernel's int counts); "cuda_core" (the
    64 x 64 ``tile_kernel`` of ``csrc/dense_grad_adam.cu``) for everything
    else: float32, ragged M, N or K, views off a 16-byte boundary, counts past
    an int."""
    m, k = x.shape if x_transposed else x.shape[::-1]
    on_rule = _on_the_wgmma_rule(x.dtype, k, m, dz.shape[1], (x, dz, w, mu, nu))
    return "wgmma" if on_rule and (k % 8 == 0 or not x_transposed) else "cuda_core"


def fused_dense_grad_adam(x: torch.Tensor, dz: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
                          nu: torch.Tensor, *, lr: float, b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8, count: int, x_transposed: bool = False) -> State:
    """One Adam step on the dense kernel ``w`` (M, N) from the layer's inputs
    ``x`` (K, M), or (M, K) with ``x_transposed``, and the gradient of its
    outputs ``dz`` (K, N); the gradient x^T . dz is never written to device
    memory. ``count`` is the number of this step (optax's count + 1).

    w, mu and nu are updated **in place** and returned (the JAX function is
    pure and its callers donate the state). All five tensors are contiguous
    matrices of one dtype (bfloat16 or float32) on one device; w, mu, nu must
    not overlap each other, x or dz. For a weight stored (out, in), swap the
    operands: ``fused_dense_grad_adam(x=dz, dz=x, w=W, ...)``.

    On the card the kernel is chosen by ``fused_arrangement``: bfloat16 on
    the tensor cores' rule runs on ``wgmma``, anything else on CUDA cores. The
    choice is never made on failure: a launch that fails raises. Each launch
    counts in ``launches["fused"]`` (``"fused_xt"`` with ``x_transposed``) and
    in ``fused_arrangements``.
    """
    _, m, n = _check_product(x, dz, x_transposed)
    _check_matrix("w", w, x.dtype, x.device, (m, n))
    _check_state(w, mu, nu)
    _check_disjoint([("w", w), ("mu", mu), ("nu", nu)], [("x", x), ("dz", dz)])
    scalars = adam_scalars(lr, b1, b2, eps, count)
    if w.device.type == "cpu":
        return fused_dense_grad_adam_reference(x, dz, w, mu, nu, lr=lr, b1=b1, b2=b2, eps=eps,
                                               count=count, x_transposed=x_transposed)
    arrangement = fused_arrangement(x, dz, w, mu, nu, x_transposed)
    _launch_fused(arrangement, x, dz, (w, mu, nu), scalars, x_transposed)
    launches["fused_xt" if x_transposed else "fused"] += 1
    fused_arrangements[arrangement] += 1
    return w, mu, nu


def _launch_fused(arrangement: str, x: torch.Tensor, dz: torch.Tensor, state: State,
                  scalars: Sequence[float], x_transposed: bool) -> None:
    """One launch of the named arrangement on checked CUDA operands, ``scalars``
    from ``adam_scalars``; counts nothing (``fused_dense_grad_adam`` counts).
    The tensor-core kernel refuses what its rule excludes, with an error."""
    m, k = x.shape if x_transposed else x.shape[::-1]
    n = dz.shape[1]
    w, mu, nu = state
    pointers = (x.data_ptr(), dz.data_ptr(), w.data_ptr(), mu.data_ptr(), nu.data_ptr())
    if arrangement == "wgmma":
        lib = build_fused_wgmma()
        with torch.cuda.device(w.device):
            rc = lib.dgaw_launch(*pointers, k, m, n, _DTYPES[w.dtype], int(x_transposed),
                                 *scalars, _stream(w))
        _raise_on_fused_wgmma(rc)
        return
    lib = build()
    with torch.cuda.device(w.device):
        rc = lib.dga_tile_launch(*pointers, k, m, n, _DTYPES[w.dtype], int(x_transposed), 1,
                                 *scalars, _stream(w))
    _raise_on(rc, "fused_dense_grad_adam")


# -- the streaming copy (row 7) -----------------------------------------------------

@torch.no_grad()
def stream_copy_reference(w: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                          out: Optional[State] = None) -> State:
    if out is None:
        return w.clone(), mu.clone(), nu.clone()
    for dst, src in zip(out, (w, mu, nu)):
        dst.copy_(src)
    return tuple(out)


def stream_copy(w: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                out: Optional[State] = None) -> State:
    """w, mu, nu (M, N) copied through registers into three outputs
    (``copy_only``, the bandwidth control: 3 tensors read, 3 written). ``out``
    gives the three outputs (each may be its own source, as the TPU probe
    aliases them; any other overlap raises), else they are allocated."""
    _check_state(w, mu, nu)
    srcs = (("w", w), ("mu", mu), ("nu", nu))
    if out is not None:
        out = tuple(out)
        if len(out) != 3:
            raise ValueError(f"out takes three tensors, got {len(out)}")
        for (name, src), dst in zip(srcs, out):
            _check_matrix(f"out[{name}]", dst, w.dtype, w.device, tuple(w.shape))
        outs = [(f"out[{name}]", dst) for (name, _), dst in zip(srcs, out)]
        for i, (name, dst) in enumerate(outs):
            others = [s for j, s in enumerate(srcs) if j != i or s[1].data_ptr() != dst.data_ptr()]
            _check_disjoint([(name, dst)], [*outs[i + 1:], *others])
    if w.device.type == "cpu":
        return stream_copy_reference(w, mu, nu, out)
    lib = build()
    if out is None:
        out = tuple(torch.empty_like(t) for t in (w, mu, nu))
    with torch.cuda.device(w.device):
        rc = lib.dga_copy_launch(w.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                                 out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                                 w.numel() * w.element_size(), _stream(w))
    _raise_on(rc, "stream_copy")
    launches["stream_copy"] += 1
    return out
