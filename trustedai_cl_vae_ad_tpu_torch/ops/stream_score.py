"""Fused streaming anomaly scorer: per-pixel EMA statistics -> scalar score.

Counterpart of ``trustedai_cl_vae_ad_tpu/ops/stream_score.py``. The update
(the TF original's live scoring block):

  * err = sum_ch (x - x_hat)^2                       (per-pixel map)
  * EMA min/max -> normalized error map
  * EMA of err and err^2, seeded from the first frame -> per-pixel z-scores
    z = (err - ema) * rsqrt(|ema2 - ema^2| + 1e-10)
  * z-of-z: standardize z over the frame, count pixels with zz > 3
  * EMA of that count and its square -> standardized scalar anomaly score
    score = (count - ema_c) / sqrt(ema_c2 - ema_c^2), NaN kept

State layout, as in the JAX package:

  maps:    (2, H, W) float32 — [err_ema, err_sq_ema]
  scalars: (6,) float32 — [err_min_ema, err_max_ema, count_ema, count_sq_ema,
                           initialized, unused]

On a CUDA tensor ``stream_score_step`` launches one of two hand-written
kernels that replace the TPU's Pallas ``_stream_kernel``, as
``stream_score_arrangement`` picks from the shape alone:
``csrc/stream_score_cluster.cu`` (one thread-block cluster of C CTAs a frame,
the frame-wide reductions joined through distributed shared memory) for
every frame whose slice of H*W/C pixels fits a CTA's shared memory, and
``csrc/stream_score.cu`` (one 1024-thread block a frame) for larger ones.
Each source's header says what bounds it and how its design answers. A
launch the card refuses raises; nothing falls back to the other kernel. On a
CPU tensor it runs ``stream_score_step_reference``, the plain PyTorch
version, which is also what the kernels are checked against on the card.

``stream_score_step_batched`` is the multi-camera tick's form: K frames with
a state each (maps (K, 2, H, W), scalars (K, 6)) and a validity mask, ONE
launch of the same kernel for all K frames on the card, a loop over the
plain version on the CPU. A stream whose frame is not valid keeps its state
and reports score NaN and count 0.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

#: launches of the CUDA kernels in this process (the plain version does not count)
launches = 0
#: launches by arrangement (each is also one of ``launches``)
stream_score_arrangements = {"cluster": 0, "block": 0}

#: shared memory a CTA of the cluster kernel may give its slice of the frame (one float a
#: pixel): the 227 KB (232,448 bytes) a Hopper block can use, less 1 KB kept for the static
#: scratch of the reductions (under 400 bytes)
SLICE_BUDGET_BYTES = 232448 - 1024
#: pixels a thread of the cluster kernel takes at a time; every slice starts on a multiple
SLICE_GROUP = 4
#: cluster sizes the rule takes: 8 is the portable size, 16 the largest Hopper allows
#: (non-portable)
CLUSTER_SIZES = (8, 16)
#: the H100 SXM's SMs: K clusters of 16 are all resident at one CTA an SM while 16 K <= 132
SMS = 132
#: frames of one launch of the cluster kernel: the grid's y limit
MAX_CLUSTER_FRAMES = 65535

_LIB_NAME = "stream_score"
_CLUSTER_LIB_NAME = "stream_score_cluster"
_lib = None
_cluster_lib = None


class StreamScoreState(NamedTuple):
    maps: torch.Tensor     # (2, H, W): [err_ema, err_sq_ema]
    scalars: torch.Tensor  # (6,): [min_ema, max_ema, as_sum, as_sum_2, initialized, 0]


def init_state(height: int, width: int, device) -> StreamScoreState:
    return StreamScoreState(
        maps=torch.zeros((2, height, width), dtype=torch.float32, device=device),
        scalars=torch.zeros((6,), dtype=torch.float32, device=device),
    )


def build():
    """Compile (first call) and load the CUDA kernel; returns the library."""
    global _lib
    if _lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_LIB_NAME)
        p = ctypes.c_void_p
        lib.stream_score_launch.argtypes = [p, p, p, p, ctypes.c_float, p, p, p, p, p, p,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        lib.stream_score_launch.restype = ctypes.c_int
        lib.stream_score_error_string.argtypes = [ctypes.c_int]
        lib.stream_score_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_cluster():
    """Compile (first call) and load the cluster kernel; returns the library."""
    global _cluster_lib
    if _cluster_lib is None:
        from trustedai_cl_vae_ad_tpu_torch.ops._build import load_library

        lib = load_library(_CLUSTER_LIB_NAME)
        p = ctypes.c_void_p
        lib.stream_score_cluster_launch.argtypes = [
            p, p, p, p, ctypes.c_float, p, p, p, p, p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        lib.stream_score_cluster_launch.restype = ctypes.c_int
        lib.stream_score_cluster_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                                       ctypes.POINTER(ctypes.c_int)]
        lib.stream_score_cluster_occupancy.restype = ctypes.c_int
        lib.stream_score_cluster_error_string.argtypes = [ctypes.c_int]
        lib.stream_score_cluster_error_string.restype = ctypes.c_char_p
        _cluster_lib = lib
    return _cluster_lib


def cluster_slice(hw: int, clusters: int) -> int:
    """Pixels a rank of a cluster of ``clusters`` CTAs owns (the last ranks may own
    fewer, or none): ceil(hw / clusters) rounded up to a multiple of ``SLICE_GROUP``, as
    ``csrc/stream_score_cluster.cu::slice_pixels`` computes it."""
    per_rank = -(-int(hw) // int(clusters))
    return -(-per_rank // SLICE_GROUP) * SLICE_GROUP


def cluster_preference(k: int) -> Tuple[int, ...]:
    """The cluster sizes for a launch of ``k`` frames, best first: 16 while the k clusters of
    16 fit the card's SMs at one CTA each (a frame then spreads over twice the SMs), else 8
    (clusters of 16 would queue behind the resident ones: an H100 holds 14 of them at once,
    30 of 8). PERF.md's row 1 has both sizes' times at K = 1 and K = 16."""
    return (16, 8) if 16 * int(k) <= SMS else (8, 16)


def stream_score_arrangement(k: int, hw: int, c: int) -> Tuple[str, int]:
    """Which kernel a launch over ``k`` frames of ``hw`` pixels and ``c`` channels takes
    on the card, by shape alone: ``("cluster", C)`` (``csrc/stream_score_cluster.cu``,
    one cluster of C CTAs a frame) with the first C of ``cluster_preference(k)`` whose slice
    of ``cluster_slice(hw, C)`` floats fits ``SLICE_BUDGET_BYTES``, for at most
    ``MAX_CLUSTER_FRAMES`` frames; else ``("block", 1)`` (``csrc/stream_score.cu``, one
    block a frame). 224x300, 240x320 and 480x640 take the cluster kernel; a 1080p frame
    (2,073,600 pixels, 518 KB a slice at C = 16) takes the block kernel."""
    if int(k) < 1 or int(hw) < 1 or int(c) < 1:
        raise ValueError(f"no frames to score: k={k}, hw={hw}, c={c}")
    if int(k) <= MAX_CLUSTER_FRAMES:
        for clusters in cluster_preference(k):
            if 4 * cluster_slice(hw, clusters) <= SLICE_BUDGET_BYTES:
                return "cluster", clusters
    return "block", 1


def build_for(k: int, hw: int, c: int):
    """Compile (first call) and load the kernel ``stream_score_arrangement`` picks for
    this shape; returns its library."""
    return build_cluster() if stream_score_arrangement(k, hw, c)[0] == "cluster" else build()


def cluster_occupancy(hw: int, clusters: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster kernel for frames of ``hw``
    pixels on clusters of ``clusters`` CTAs, on the current CUDA device (builds the
    kernel; raises what the card refuses)."""
    lib = build_cluster()
    active = ctypes.c_int(0)
    rc = lib.stream_score_cluster_occupancy(int(hw), int(clusters), ctypes.byref(active))
    if rc != 0:
        raise RuntimeError(f"stream_score cluster occupancy query failed: "
                           f"{lib.stream_score_cluster_error_string(rc).decode()}")
    return active.value


def stream_score_step_reference(state: StreamScoreState, img: torch.Tensor,
                                rec: torch.Tensor, alpha) -> Tuple[StreamScoreState, torch.Tensor,
                                                                   torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of one update (the JAX ``_score_math``).

    Every elementwise step is one IEEE-rounded op in the JAX order; the
    channel sum runs in channel order and 1/sqrt is written out, so the
    per-pixel values match the kernel bit for bit and only the frame-wide
    sums differ in their order.
    """
    maps, scalars = state.maps, state.scalars
    a = torch.as_tensor(alpha, dtype=torch.float32, device=img.device)
    oma = 1.0 - a
    d = img - rec
    err = d[..., 0] * d[..., 0]
    for ch in range(1, img.shape[-1]):
        err = err + d[..., ch] * d[..., ch]
    initialized = scalars[4] > 0
    min_ema = a * scalars[0] + oma * err.min()
    max_ema = a * scalars[1] + oma * err.max()
    denom = max_ema - min_ema
    norm = (err - min_ema) / torch.where(denom == 0, torch.ones_like(denom), denom)

    prev_ema = torch.where(initialized, maps[0], err)
    prev_ema2 = torch.where(initialized, maps[1], err * err)
    err_ema = a * prev_ema + oma * err
    err_ema2 = a * prev_ema2 + oma * err * err
    var = torch.abs(err_ema2 - err_ema * err_ema)
    z = (err - err_ema) * torch.reciprocal(torch.sqrt(var + 1e-10))

    n = float(z.numel())
    z_mean = z.sum() / n
    zc = z - z_mean
    z_std = torch.sqrt((zc * zc).sum() / n)
    zz = zc / torch.where(z_std == 0, torch.ones_like(z_std), z_std)
    count = (zz > 3.0).sum().to(torch.float32)

    as_sum = a * scalars[2] + oma * count
    as_sum2 = a * scalars[3] + oma * count * count
    # the TF original takes sqrt of the RAW variance estimate: NaN when it
    # is 0 or rounds negative, filtered downstream as the engines do
    a_var = as_sum2 - as_sum * as_sum
    score = (count - as_sum) / torch.sqrt(a_var)

    one = torch.ones_like(count)
    new_scalars = torch.stack([min_ema, max_ema, as_sum, as_sum2, one, torch.zeros_like(one)])
    return StreamScoreState(torch.stack([err_ema, err_ema2]), new_scalars), norm, score, count


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(arrangement: str, clusters: int, lead, img, rec, maps, scalars, alpha: float,
            valid):
    """One launch of the named kernel (clusters of ``clusters`` CTAs for "cluster",
    ignored for "block") over ``lead`` = () (one frame) or (K,) frames; the tensors are
    checked here. ``valid``: None, or a (K,) bool tensor. Counts nothing; returns the
    outputs."""
    h, w, c = img.shape[-3:]
    dev = img.device
    _check("img", img, (*lead, h, w, c), dev)
    _check("rec", rec, (*lead, h, w, c), dev)
    _check("maps", maps, (*lead, 2, h, w), dev)
    _check("scalars", scalars, (*lead, 6), dev)
    out_maps = torch.empty((*lead, 2, h, w), dtype=torch.float32, device=dev)
    out_scalars = torch.empty((*lead, 6), dtype=torch.float32, device=dev)
    norm = torch.empty((*lead, h, w), dtype=torch.float32, device=dev)
    score_count = torch.empty((*lead, 2), dtype=torch.float32, device=dev)
    k = lead[0] if lead else 1
    valid_ptr = None if valid is None else valid.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if arrangement == "cluster":
            lib = build_cluster()
            error = lib.stream_score_cluster_error_string
            rc = lib.stream_score_cluster_launch(
                img.data_ptr(), rec.data_ptr(), maps.data_ptr(), scalars.data_ptr(),
                float(alpha), out_maps.data_ptr(), out_scalars.data_ptr(), norm.data_ptr(),
                score_count.data_ptr(), valid_ptr, k, h * w, c, int(clusters), stream)
        elif arrangement == "block":
            lib = build()
            error = lib.stream_score_error_string
            zbuf = torch.empty((*lead, h, w), dtype=torch.float32, device=dev)
            rc = lib.stream_score_launch(
                img.data_ptr(), rec.data_ptr(), maps.data_ptr(), scalars.data_ptr(),
                float(alpha), out_maps.data_ptr(), out_scalars.data_ptr(), norm.data_ptr(),
                score_count.data_ptr(), zbuf.data_ptr(), valid_ptr, k, h * w, c, stream)
        else:
            raise ValueError(f"unknown arrangement {arrangement!r}")
    if rc != 0:
        raise RuntimeError(f"stream_score ({arrangement}) kernel launch failed: "
                           f"{error(rc).decode()}")
    return out_maps, out_scalars, norm, score_count


def _launch_by_rule(lead, img, rec, maps, scalars, alpha: float, valid):
    """Launch the arrangement the rule picks for this shape and count the launch."""
    global launches
    h, w, c = img.shape[-3:]
    arrangement, clusters = stream_score_arrangement(lead[0] if lead else 1, h * w, c)
    out = _launch(arrangement, clusters, lead, img, rec, maps, scalars, alpha, valid)
    launches += 1
    stream_score_arrangements[arrangement] += 1
    return out


def _stream_cuda(state: StreamScoreState, img: torch.Tensor, rec: torch.Tensor, alpha: float):
    out_maps, out_scalars, norm, score_count = _launch_by_rule(
        (), img, rec, state.maps, state.scalars, alpha, None)
    return StreamScoreState(out_maps, out_scalars), norm, score_count[0], score_count[1]


def stream_score_step(state: StreamScoreState, img: torch.Tensor, rec: torch.Tensor,
                      alpha: float) -> Tuple[StreamScoreState, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """One scorer update. img/rec: (H, W, C) f32 in [0, 1]; alpha: EMA weight
    (a Python float). Returns (new_state, norm_err_map, score, pixel_count).

    CUDA tensors go through the kernel ``stream_score_arrangement`` picks (or
    raise); CPU tensors through the plain version."""
    if img.device.type == "cuda":
        return _stream_cuda(state, img, rec, alpha)
    if img.device.type != "cpu":
        raise ValueError(f"stream_score_step supports cuda and cpu tensors, got {img.device}")
    return stream_score_step_reference(state, img, rec, alpha)


def stream_score_step_batched_reference(maps: torch.Tensor, scalars: torch.Tensor,
                                        img: torch.Tensor, rec: torch.Tensor, alpha,
                                        valid: torch.Tensor):
    """The plain batched version: ``stream_score_step_reference`` stream by
    stream, then the validity mask (the JAX engine's ``scorer_one``)."""
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=img.device)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    out_maps, out_scalars, norms, score_counts = [], [], [], []
    for k in range(img.shape[0]):
        state, norm, score, count = stream_score_step_reference(
            StreamScoreState(maps[k], scalars[k]), img[k], rec[k], alpha)
        ok = valid[k]
        out_maps.append(torch.where(ok, state.maps, maps[k]))
        out_scalars.append(torch.where(ok, state.scalars, scalars[k]))
        norms.append(norm)
        score_counts.append(torch.stack([torch.where(ok, score, nan),
                                         torch.where(ok, count, zero)]))
    return (torch.stack(out_maps), torch.stack(out_scalars), torch.stack(norms),
            torch.stack(score_counts))


def stream_score_step_batched(maps: torch.Tensor, scalars: torch.Tensor, img: torch.Tensor,
                              rec: torch.Tensor, alpha: float, valid: torch.Tensor):
    """One scorer update of K streams. maps (K, 2, H, W), scalars (K, 6),
    img / rec (K, H, W, C) f32 in [0, 1], valid (K,) bool; alpha a Python
    float. Returns (new maps, new scalars, norm maps (K, H, W), [score,
    count] (K, 2)).

    CUDA tensors go through the kernel ``stream_score_arrangement`` picks, one
    launch for all K (or raise); CPU tensors through the plain version."""
    if img.dim() != 4:
        raise ValueError(f"img must be (K, H, W, C), got shape {tuple(img.shape)}")
    if valid.dtype != torch.bool or valid.device != img.device \
            or tuple(valid.shape) != (img.shape[0],) or not valid.is_contiguous():
        raise ValueError(f"valid must be a contiguous bool tensor of shape ({img.shape[0]},) on "
                         f"{img.device}, got {valid.dtype} {tuple(valid.shape)} on {valid.device}")
    if img.device.type == "cuda":
        return _launch_by_rule((img.shape[0],), img, rec, maps, scalars, alpha, valid)
    if img.device.type != "cpu":
        raise ValueError(f"stream_score_step_batched supports cuda and cpu tensors, "
                         f"got {img.device}")
    return stream_score_step_batched_reference(maps, scalars, img, rec, alpha, valid)
