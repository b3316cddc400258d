"""The whole tick's share of the card's peak, in %: a forward's operations (from the
shapes) times the frames of the traced ticks, over the traced window and the peak of
the configuration's precision (float32: 67 TFLOP/s, TF32 off)."""

from perfbench.yardstick.bounds import forward_flops, peak_flops


def read(ctx):
    t = ctx.trace
    if t.busy_s <= 0:
        return None
    flops = forward_flops(ctx.config) * ctx.frames_per_step * t.steps
    return 100.0 * flops / t.window_s / peak_flops(ctx.config)
