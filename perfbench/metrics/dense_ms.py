"""Device ms a training step or a tick of the operations launched by ATen's
matrix-product ops (the Dense layers of ``models/cvae.py``, forward and backward)."""

from perfbench.yardstick.trace import ATEN_MATMUL


def read(ctx):
    ops = ctx.trace.launched_in(ATEN_MATMUL)
    return ctx.trace.ms_per_step(ops) if ops else None
