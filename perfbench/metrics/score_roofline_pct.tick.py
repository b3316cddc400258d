"""Kernel 1's share of its roofline, in %: the least time of a tick's scorer launch
(the bytes of its frames, ``stream_score`` copied from ``kernel_bounds_torch.py``, over
3.35 TB/s) over the device time of what the range around
``ops/stream_score.py::stream_score_step_batched`` launched."""

from perfbench.drivers.camera_ticks import SCORE
from perfbench.yardstick.bounds import HBM_BYTES_PER_S, stream_score


def read(ctx):
    ops = ctx.trace.launched_in([SCORE])
    if not ops:
        return None
    h, w, c = (int(v) for v in ctx.config["data"]["image_size"])
    nbytes, _ = stream_score(ctx.frames_per_step, h, w, c)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return 100.0 * bound_ms / ctx.trace.ms_per_step(ops)
