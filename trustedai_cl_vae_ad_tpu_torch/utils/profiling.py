"""Signal deferral and host-memory probe for the streaming loop.

Counterparts of ``defer_signals`` and ``rss_mb`` in
``trustedai_cl_vae_ad_tpu/utils/profiling.py``, which imports jax.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def defer_signals(sigs=None):
    """Defer SIGINT/SIGTERM handling to the end of the block.

    The engine updates its device ring in place and then re-assigns the
    scorer state; an interrupt between the two would leave a ring that has
    seen a frame the scorer has not. The block swaps in a handler that only
    records the signal, restores the original handlers on exit and
    re-raises the recorded signals there, where the state is whole. Python
    runs handlers only in the main thread, so elsewhere this is a no-op.
    """
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        yield
        return
    if sigs is None:
        sigs = (signal.SIGINT, signal.SIGTERM)
    pending: list[int] = []
    previous = {}
    for s in sigs:
        previous[s] = signal.signal(s, lambda signum, frame: pending.append(signum))
    try:
        yield
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
        for signum in dict.fromkeys(pending):
            signal.raise_signal(signum)


def rss_mb() -> float:
    """This process's resident set size in MB (Linux /proc; 0.0 elsewhere)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):
        return 0.0
