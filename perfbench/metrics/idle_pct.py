"""Share of the traced window, in %, with no kernel and no copy on the device."""


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    return 100.0 * ctx.trace.analysis["idle_share"]
