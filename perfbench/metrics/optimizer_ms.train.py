"""Device ms a step of the operations launched inside the range the benchmark puts
around the optimizer instance's ``step`` (``ops/adam.py``)."""

from perfbench.drivers.train_steps import OPTIMIZER


def read(ctx):
    ops = ctx.trace.launched_in([OPTIMIZER])
    return ctx.trace.ms_per_step(ops) if ops else None
