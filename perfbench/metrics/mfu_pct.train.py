"""The whole training step's share of the card's peak, in %: three forwards' operations
(the forward, and the backward's two products a layer; from the shapes) times the
frames of the traced steps, over the traced window and the peak of the configuration's
precision (float32: 67 TFLOP/s, TF32 off)."""

from perfbench.yardstick.bounds import forward_flops, peak_flops


def read(ctx):
    t = ctx.trace
    if t.busy_s <= 0:
        return None
    flops = 3 * forward_flops(ctx.config) * ctx.frames_per_step * t.steps
    return 100.0 * flops / t.window_s / peak_flops(ctx.config)
