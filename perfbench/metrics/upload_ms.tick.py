"""Device ms a tick of host-to-device copies (the frames' upload in
``stream/multicam.py``, and the validity mask's)."""


def read(ctx):
    ops = ctx.trace.copies("HtoD")
    return ctx.trace.ms_per_step(ops) if ops else None
