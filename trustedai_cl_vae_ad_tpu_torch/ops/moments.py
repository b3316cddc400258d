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
hand-written kernels of ``csrc/moments_cluster.cu``: each forward is one
launch on thread-block clusters whose joins go through distributed shared
memory, arranged by ``moments_arrangement`` from the shape, dtype and
alignment alone, and each backward one streaming launch. The kernels of
``csrc/moments.cu`` (three launches for the global forward) stay as the
yardstick the new ones are timed and checked against; only a caller that
names the arrangement ``"blocks"`` reaches them. Each source's header says
what bounds it and how each reduction is made repeatable. A launch the card
refuses raises; nothing falls back to the other source. On a CPU tensor they
run the plain PyTorch versions below, which are also what the kernels are
checked against on the card. Neither direction reads a value back on the
host. The weighted variants are plain PyTorch with autograd on either
device, as the JAX package leaves them to autodiff.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
from torch.autograd.function import once_differentiable

#: forward launches of the global CUDA kernels in this process (plain versions do not count)
launches = 0
#: backward launches of the global CUDA kernels in this process
bwd_launches = 0
#: forward and backward launches of the per-dimension CUDA kernels
perdim_launches = 0
perdim_bwd_launches = 0
#: the launches above by arrangement: "cluster" (``csrc/moments_cluster.cu``, which every
#: CUDA tensor takes) and "blocks" (``csrc/moments.cu``, only when a caller names it)
OPS = ("global_forward", "global_backward", "perdim_forward", "perdim_backward")
ARRANGEMENTS = ("cluster", "blocks")
moments_arrangements = {op: dict.fromkeys(ARRANGEMENTS, 0) for op in OPS}

_LIB_NAME = "moments_cluster"
_BLOCKS_LIB_NAME = "moments"
_lib = None
_blocks_lib = None

_THREADS = 256      # kThreads in csrc/moments.cu
_MAX_BLOCKS = 1024  # kMaxBlocks in csrc/moments.cu
_DTYPES = (torch.float32, torch.bfloat16)

#: CTAs of the global forward's one cluster: Hopper's largest (non-portable)
GLOBAL_CLUSTER = 16
#: CTAs at most in a per-dimension forward's cluster: the portable limit
MAX_PERDIM_CLUSTER = 8
#: the H100 SXM's SMs: the per-dimension clusters of a launch fill at most these
SMS = 132
#: shared memory a CTA may stage its share of z in: the 227 KB (232,448 bytes) a Hopper
#: block can use, less 32 KB kept for the static scratch of the joins (under 21 KB)
STAGE_BUDGET_BYTES = 232448 - 32768
#: bytes a lane reads at once; a per-dimension tile is 32 lanes of this many
VECTOR_BYTES = 16

Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class MomentsArrangement(NamedTuple):
    """How ``csrc/moments_cluster.cu`` lays one forward out on the card."""

    kind: str      # "global" or "perdim"
    cluster: int   # CTAs a cluster: C (global) or R (per dimension)
    tiles: int     # clusters in the grid: 1 (global), tiles of tile_columns columns (perdim)
    slice: int     # a rank's share: elements of the flattened z (global), rows (perdim)
    staged: bool   # the share held in shared memory for the second pass (read from HBM once)
    vector: bool   # 16-byte accesses (else scalar ones, in the same kernel)


def tile_columns(dtype: torch.dtype) -> int:
    """Columns of a per-dimension tile: 32 lanes of 16 bytes, 128 float32 or 256
    bfloat16 (``PerdimScratch::kCols`` in the source)."""
    return 32 * (VECTOR_BYTES // _elem_size(dtype))


def _elem_size(dtype: torch.dtype) -> int:
    if dtype not in _DTYPES:
        raise TypeError(f"z must be float32 or bfloat16, got {dtype}")
    return 2 if dtype == torch.bfloat16 else 4


@functools.lru_cache(maxsize=256)
def moments_arrangement(kind: str, shape: Tuple[int, int], dtype: torch.dtype,
                        aligned: bool) -> MomentsArrangement:
    """The forward's arrangement for z of ``shape`` and ``dtype``, ``aligned`` when z starts
    on a 16-byte boundary: a function of these alone.

    ``"global"``: one cluster of ``GLOBAL_CLUSTER`` CTAs; rank r owns elements
    [r s, min((r + 1) s, n)) of the n = B L, with s = ceil(n / C) rounded up to 16 bytes of
    z, so every slice starts on a 16-byte boundary. Staged where z is aligned and s fits
    ``STAGE_BUDGET_BYTES``: the flagship's (256, 2000) in both dtypes. Else streamed (both
    passes read z): (768, 2000) float32, and every view off 16 bytes.

    ``"perdim"``: one cluster of R CTAs a tile of ``tile_columns`` adjacent columns, R the
    largest of 8, 4, 2, 1 that is at most B and keeps the tiles' clusters within ``SMS``
    CTAs (the flagship's (256, 2000) float32: 16 tiles of 8); rank r owns rows
    [r s, min((r + 1) s, B)) with s = ceil(B / R). Staged where those rows of a tile fit
    the budget; 16-byte accesses where z is aligned and a row is a multiple of 16 bytes."""
    rows, cols = (int(d) for d in shape)
    if kind not in ("global", "perdim"):
        raise ValueError(f"kind must be 'global' or 'perdim', got {kind!r}")
    if rows < 1 or cols < 1:
        raise ValueError(f"no moments of an empty z of shape {tuple(shape)}")
    size = _elem_size(dtype)
    width = VECTOR_BYTES // size
    if kind == "global":
        n = rows * cols
        per_rank = -(-n // GLOBAL_CLUSTER)
        slice_ = -(-per_rank // width) * width
        return MomentsArrangement("global", GLOBAL_CLUSTER, 1, slice_,
                                  bool(aligned) and slice_ * size <= STAGE_BUDGET_BYTES,
                                  bool(aligned))
    tile = tile_columns(dtype)
    tiles = -(-cols // tile)
    cluster = MAX_PERDIM_CLUSTER
    while cluster > 1 and (cluster > rows or tiles * cluster > SMS):
        cluster //= 2
    share = -(-rows // cluster)
    return MomentsArrangement("perdim", cluster, tiles, share,
                              share * tile * size <= STAGE_BUDGET_BYTES,
                              bool(aligned) and (cols * size) % VECTOR_BYTES == 0)


def build():
    """Compile (first call) and load ``csrc/moments_cluster.cu``, the kernels every CUDA
    tensor takes; returns the library."""
    global _lib
    if _lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_LIB_NAME)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mc_global_forward.argtypes = [p, i, ll, i, ll, i, p, i, p]
        lib.mc_perdim_forward.argtypes = [p, i, ll, ll, i, ll, i, p, i, p]
        lib.mc_global_backward.argtypes = [p, i, ll, p, p, p, i, p]
        lib.mc_perdim_backward.argtypes = [p, i, ll, ll, p, p, p, i, p]
        lib.mc_occupancy.argtypes = [i, i, i, ll, i, ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.mc_global_forward, lib.mc_perdim_forward, lib.mc_global_backward,
                   lib.mc_perdim_backward, lib.mc_occupancy):
            fn.restype = i
        lib.mc_error_string.argtypes = [i]
        lib.mc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_blocks():
    """Compile (first call) and load ``csrc/moments.cu``, the yardstick; returns the
    library."""
    global _blocks_lib
    if _blocks_lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_BLOCKS_LIB_NAME)
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
        _blocks_lib = lib
    return _blocks_lib


def cluster_occupancy(arrangement: MomentsArrangement, dtype: torch.dtype) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the forward of ``arrangement`` on the current
    CUDA device (builds the kernels; raises what the card refuses)."""
    lib = build()
    size = _elem_size(dtype)
    share = arrangement.slice * (1 if arrangement.kind == "global" else tile_columns(dtype))
    smem = share * size if arrangement.staged else 0
    active = ctypes.c_int(0)
    rc = lib.mc_occupancy(0 if arrangement.kind == "global" else 1,
                          int(dtype == torch.bfloat16), arrangement.cluster, smem,
                          torch.cuda.current_device(), ctypes.byref(active))
    if rc != 0:
        raise RuntimeError(f"moments cluster occupancy query failed: "
                           f"{lib.mc_error_string(rc).decode()}")
    return active.value


def reset_counts() -> None:
    """Every launch count of this module back to 0."""
    global launches, bwd_launches, perdim_launches, perdim_bwd_launches
    launches = bwd_launches = perdim_launches = perdim_bwd_launches = 0
    for counts in moments_arrangements.values():
        counts.update(dict.fromkeys(ARRANGEMENTS, 0))


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
    if not (z.is_cuda or z.is_cpu):
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
    """Blocks of ``csrc/moments.cu``'s global forward's two reducing launches: one 16-byte
    vector per thread, capped; a function of the element count and type alone, so the
    order of the sums is the same from run to run."""
    n_vec = z.numel() // (16 // z.element_size())
    return max(1, min(_MAX_BLOCKS, -(-n_vec // _THREADS)))


def _check_packed(name: str, t: torch.Tensor, z: torch.Tensor, shape=(4,)) -> None:
    if t.get_device() != z.get_device() or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {tuple(shape)} tensor on "
                         f"{z.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


#: a tensor of each output shape on each device, whose layout ``torch.empty_like`` copies:
#: cheaper on the host than ``torch.empty`` with a device argument on every call
_out_templates = {}


def _empty_out(z: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    key = (z.get_device(), shape)
    template = _out_templates.get(key)
    if template is None:
        template = _out_templates[key] = torch.empty(shape, dtype=torch.float32,
                                                     device=z.device)
    return torch.empty_like(template)


def _raw_stream(index: int) -> int:
    """The handle of the current CUDA stream of device ``index``, read as PyTorch's own
    compiled code reads it: without building the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream`` returns, which costs more host time than the launch."""
    return torch._C._cuda_getCurrentRawStream(index)


def _raise_on(rc: int, error, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"moments kernel {what} launch failed: {error(rc).decode()}")


def _cluster_launch(op: str, z: torch.Tensor, arrangement=None, moments=None,
                    gout=None) -> torch.Tensor:
    """One launch of ``csrc/moments_cluster.cu``'s ``op``, uncounted: a forward in
    ``arrangement`` (by default ``moments_arrangement``'s), a backward on its fixed grid."""
    lib = _lib if _lib is not None else build()
    bf16 = int(z.dtype == torch.bfloat16)
    index = z.get_device()
    stream = _raw_stream(index)
    rows, cols = z.shape
    if op.endswith("forward"):
        kind = op[:-len("_forward")]
        ptr = z.data_ptr()
        arr = arrangement or moments_arrangement(kind, z.shape, z.dtype,
                                                 ptr % VECTOR_BYTES == 0)
        if arr.kind != kind:
            raise ValueError(f"{op} cannot take a {arr.kind} arrangement")
        if kind == "global":
            out = _empty_out(z, (4,))
            rc = lib.mc_global_forward(ptr, bf16, rows * cols, arr.cluster, arr.slice,
                                       int(arr.staged), out.data_ptr(), index, stream)
        else:
            out = _empty_out(z, (4, cols))
            rc = lib.mc_perdim_forward(ptr, bf16, rows, cols, arr.cluster, arr.slice,
                                       int(arr.staged), out.data_ptr(), index, stream)
        _raise_on(rc, lib.mc_error_string, f"{op} ({arr})")
        return out
    out = torch.empty_like(z)
    if op == "global_backward":
        rc = lib.mc_global_backward(z.data_ptr(), bf16, rows * cols, moments.data_ptr(),
                                    gout.data_ptr(), out.data_ptr(), index, stream)
    else:
        rc = lib.mc_perdim_backward(z.data_ptr(), bf16, rows, cols, moments.data_ptr(),
                                    gout.data_ptr(), out.data_ptr(), index, stream)
    _raise_on(rc, lib.mc_error_string, op)
    return out


def _blocks_launch(op: str, z: torch.Tensor, moments=None, gout=None) -> torch.Tensor:
    """One launch sequence of ``csrc/moments.cu``'s ``op`` (three launches for the global
    forward), uncounted."""
    lib = build_blocks()
    bf16 = int(z.dtype == torch.bfloat16)
    rows, cols = z.shape
    with torch.cuda.device_of(z):
        stream = torch.cuda.current_stream().cuda_stream
        if op == "global_forward":
            blocks = forward_blocks(z)
            partial = torch.empty((4 * blocks,), dtype=torch.float32, device=z.device)
            out = torch.empty((4,), dtype=torch.float32, device=z.device)
            rc = lib.moments_global_forward(z.data_ptr(), bf16, z.numel(), blocks,
                                            partial.data_ptr(), out.data_ptr(), stream)
        elif op == "perdim_forward":
            out = torch.empty((4, cols), dtype=torch.float32, device=z.device)
            rc = lib.moments_perdim_forward(z.data_ptr(), bf16, rows, cols, out.data_ptr(),
                                            stream)
        elif op == "global_backward":
            out = torch.empty_like(z)
            rc = lib.moments_global_backward(z.data_ptr(), bf16, z.numel(), moments.data_ptr(),
                                             gout.data_ptr(), out.data_ptr(), stream)
        else:
            out = torch.empty_like(z)
            rc = lib.moments_perdim_backward(z.data_ptr(), bf16, rows, cols, moments.data_ptr(),
                                             gout.data_ptr(), out.data_ptr(), stream)
    _raise_on(rc, lib.moments_error_string, f"{op} (blocks)")
    return out


def _launch(op: str, arrangement, z: torch.Tensor, moments=None, gout=None) -> torch.Tensor:
    """One launch of ``op`` (one of ``OPS``) on the card, uncounted. ``arrangement``:
    "cluster", "blocks", or for a forward a ``MomentsArrangement`` of the cluster source
    (staged and streamed can be compared on one shape that way). The caller checks the
    tensors."""
    if arrangement == "blocks":
        return _blocks_launch(op, z, moments, gout)
    if arrangement == "cluster":
        return _cluster_launch(op, z, None, moments, gout)
    if isinstance(arrangement, MomentsArrangement) and op.endswith("forward"):
        return _cluster_launch(op, z, arrangement)
    raise ValueError(f"unknown arrangement {arrangement!r} for {op}: one of {ARRANGEMENTS}")


def _launch_counted(op: str, arrangement, z: torch.Tensor, moments=None,
                    gout=None) -> torch.Tensor:
    """``_launch`` of the named arrangement ("cluster" when None), counted."""
    global launches, bwd_launches, perdim_launches, perdim_bwd_launches
    name = "cluster" if arrangement is None else arrangement
    if name == "cluster":
        out = _cluster_launch(op, z, None, moments, gout)
    elif name == "blocks":
        out = _blocks_launch(op, z, moments, gout)
    else:
        raise ValueError(f"unknown arrangement {arrangement!r}: one of {ARRANGEMENTS}")
    if op == "global_forward":
        launches += 1
    elif op == "global_backward":
        bwd_launches += 1
    elif op == "perdim_forward":
        perdim_launches += 1
    else:
        perdim_bwd_launches += 1
    moments_arrangements[op][name] += 1
    return out


def global_moments_packed(z: torch.Tensor, arrangement=None) -> torch.Tensor:
    """The four moments as one (4,) float32 tensor, no autograd: one launch of
    the cluster kernel on a CUDA tensor (``arrangement="blocks"`` takes
    ``csrc/moments.cu`` instead), the plain version on a CPU tensor."""
    _check_input(z)
    if z.is_cuda:
        return _launch_counted("global_forward", arrangement, z)
    return torch.stack(global_moments_reference(z))


def global_moments_backward(z: torch.Tensor, moments: torch.Tensor,
                            gout: torch.Tensor, arrangement=None) -> torch.Tensor:
    """d(sum_k gout[k] * moments[k]) / dz, in z's dtype: the kernel on a CUDA
    tensor (``arrangement`` as in ``global_moments_packed``), the plain
    analytic version on a CPU tensor."""
    _check_input(z)
    gout = gout.contiguous()
    _check_packed("moments", moments, z)
    _check_packed("gout", gout, z)
    if z.is_cuda:
        return _launch_counted("global_backward", arrangement, z, moments, gout)
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


def perdim_moments_packed(z: torch.Tensor, arrangement=None) -> torch.Tensor:
    """The four per-dimension moments as one (4, L) float32 tensor (rows
    mean, var, skew, kurt), no autograd: one launch of the cluster kernel on a
    CUDA tensor (``arrangement="blocks"`` takes ``csrc/moments.cu`` instead),
    the plain version on a CPU tensor."""
    _check_input(z)
    if z.is_cuda:
        return _launch_counted("perdim_forward", arrangement, z)
    return torch.stack(perdim_moments_reference(z))


def perdim_moments_backward(z: torch.Tensor, moments: torch.Tensor,
                            gout: torch.Tensor, arrangement=None) -> torch.Tensor:
    """d(sum_kl gout[k, l] * moments[k, l]) / dz, in z's dtype: the kernel on
    a CUDA tensor (``arrangement`` as in ``perdim_moments_packed``), the plain
    analytic version on a CPU tensor."""
    _check_input(z)
    gout = gout.contiguous()
    _check_packed("moments", moments, z, (4, z.shape[1]))
    _check_packed("gout", gout, z, (4, z.shape[1]))
    if z.is_cuda:
        return _launch_counted("perdim_backward", arrangement, z, moments, gout)
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
