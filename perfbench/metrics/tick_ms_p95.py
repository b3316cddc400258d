"""The 95th percentile of every tick of the measured window, in ms, each timed by the
host's clock from the call of ``process_frames`` to its return (``drivers/camera_ticks.py``).
A closed loop of ticks runs at the card's capacity, where a tail swings with the host's
load, so it is a per-layer reading beside the cell's rate, with no bound of its own."""


def read(ctx):
    return ctx.window.get("tick_ms_p95")
