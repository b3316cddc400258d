"""Device ms a training step or a tick of the operations launched by ATen's
convolution ops (forward, transposed and backward; ``models/cvae.py``)."""

from perfbench.yardstick.trace import ATEN_CONV


def read(ctx):
    ops = ctx.trace.launched_in(ATEN_CONV)
    return ctx.trace.ms_per_step(ops) if ops else None
