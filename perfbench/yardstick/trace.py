"""Reading a torch.profiler Chrome trace: device busy time, and device time by
what launched it.

``short_name`` and ``analyze_trace`` are frozen copies of
``profile_stream_torch.py::short_name`` and ``::analyze_trace`` at commit
d792d55, unchanged but for this header. The benchmark keeps its own copy so
that a later change to the program cannot move the yardstick.

``Trace`` adds what the per-layer metrics read: the device time of the kernels
and copies that a CPU range launched (a ``record_function`` range of the
benchmark's own, or an ATen op), joined through the launch's correlation id.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host-side events of a launch: the CUDA runtime's and the driver's calls
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("user_annotation", "cpu_op")
#: the ATen ops whose launches are a convolution's (forward, transposed, backward)
ATEN_CONV = ("aten::conv2d", "aten::conv_transpose2d", "aten::convolution",
             "aten::_convolution", "aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
             "aten::convolution_backward")
#: the ATen ops whose launches are a matrix product's
ATEN_MATMUL = ("aten::linear", "aten::matmul", "aten::mm", "aten::addmm", "aten::bmm",
               "aten::baddbmm")


# -- frozen copy of profile_stream_torch.py (d792d55) ------------------------------------
def short_name(name: str, width: int = 72) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list; copies keep their kind ("Memcpy HtoD")."""
    depth, kept = 0, []
    for ch in name.replace("->", " "):
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            kept.append(ch)
    # "(anonymous namespace)" inside a qualified name leaves "::::"
    tokens = "".join(kept).replace("::::", "::").split()
    if not tokens:
        return name[:width]
    if "::" in tokens[-1] or tokens[0] == "void":
        return tokens[-1].lstrip(":")[:width]
    return " ".join(tokens)[:width]


def analyze_trace(events, n_frames: int, frame_label: str = "frame"):
    """Per-frame device time by kernel, and the device's busy share of the
    frames' wall time, from Chrome-trace events (torch.profiler export).

    The window runs from the first ``frame_label`` annotation's start to the
    last one's end; busy time is the union of the device intervals inside it.
    """
    frames = [e for e in events if e.get("name") == frame_label and e.get("ph") == "X"
              and e.get("cat") in ("user_annotation", "cpu_op")]
    if not frames:
        raise ValueError(f"no {frame_label!r} annotations in the trace")
    t0 = min(e["ts"] for e in frames)
    t1 = max(e["ts"] + e["dur"] for e in frames)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
           and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    by_name = {}
    for e in dev:
        key = short_name(e["name"])
        tot, cnt = by_name.get(key, (0.0, 0))
        by_name[key] = (tot + e["dur"], cnt + 1)
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev)
    busy, end = 0.0, t0
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    window = t1 - t0
    rows = sorted(({"kernel": k, "ms_per_frame": tot / 1e3 / n_frames,
                    "launches_per_frame": cnt / n_frames}
                   for k, (tot, cnt) in by_name.items()),
                  key=lambda r: -r["ms_per_frame"])
    return {
        "window_ms_per_frame": window / 1e3 / n_frames,
        "device_sum_ms_per_frame": sum(e["dur"] for e in dev) / 1e3 / n_frames,
        "device_busy_ms_per_frame": busy / 1e3 / n_frames,
        "busy_share": busy / window if window > 0 else 0.0,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "kernels": rows,
    }
# -- end of the frozen copy --------------------------------------------------------------


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """The events of one traced window of ``steps`` steps (ticks), labelled by one
    ``window_label`` range that opens after a device synchronize and closes after
    another, so that every device operation of the steps lies inside it."""

    def __init__(self, events: list, steps: int, window_label: str):
        self.events = [e for e in events if e.get("ph") == "X"]
        self.steps = int(steps)
        self.window_label = window_label
        self.analysis = analyze_trace(self.events, self.steps, window_label)
        label = [e for e in self.events if e.get("name") == window_label
                 and e.get("cat") in RANGE_CATS]
        self.t0 = min(e["ts"] for e in label)
        self.t1 = max(e["ts"] + e["dur"] for e in label)
        self.device = [e for e in self.events if e.get("cat") in DEVICE_CATS
                       and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self._launch_of: Dict[int, dict] = {}
        for e in self.events:
            if e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self._launch_of[corr] = e

    # -- the window as a whole -------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return self.analysis["busy_share"] * self.window_s

    # -- device time by what launched it ---------------------------------------------
    def _ranges(self, names: Iterable[str]) -> Dict[object, List[Tuple[float, float]]]:
        """The union, thread by thread, of the CPU ranges with one of ``names``."""
        names = set(names)
        by_tid: Dict[object, list] = {}
        for e in self.events:
            if e.get("cat") in RANGE_CATS and e.get("name") in names:
                by_tid.setdefault(e.get("tid"), []).append((e["ts"], e["ts"] + e["dur"]))
        return {tid: _union(iv) for tid, iv in by_tid.items()}

    def launched_in(self, names: Iterable[str]) -> List[dict]:
        """The device operations of the window whose launch (the runtime or driver call
        with the same correlation id) ran inside a CPU range named one of ``names``."""
        ranges = self._ranges(names)
        starts = {tid: [a for a, _ in iv] for tid, iv in ranges.items()}
        out = []
        for e in self.device:
            launch = self._launch_of.get((e.get("args") or {}).get("correlation"))
            if launch is None or launch.get("tid") not in ranges:
                continue
            iv, st = ranges[launch["tid"]], starts[launch["tid"]]
            i = bisect.bisect_right(st, launch["ts"]) - 1
            if i >= 0 and launch["ts"] <= iv[i][1]:
                out.append(e)
        return out

    def ms_per_step(self, ops: List[dict]) -> float:
        return sum(e["dur"] for e in ops) / 1e3 / self.steps

    def copies(self, kind: str) -> List[dict]:
        """The window's device copies of one kind ("HtoD", "DtoH", "DtoD")."""
        return [e for e in self.device if e.get("cat") == "gpu_memcpy" and kind in e["name"]]

    # -- the breakdown of the result line ---------------------------------------------
    def top_device_ops(self, n: int = 10) -> List[list]:
        """[short name, device seconds a step] of the n operations that took most time."""
        return [[r["kernel"], r["ms_per_frame"] / 1e3] for r in self.analysis["kernels"][:n]]

    def idle_gaps(self, prefix: str, n: int = 10) -> List[list]:
        """[label, seconds] of the n longest stretches of the window with nothing on the
        device, each labelled with the innermost range whose name starts with ``prefix``
        that the host was in at the gap's middle ("none" outside all of them)."""
        busy = _union((max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                      for e in self.device)
        gaps, end = [], self.t0
        for a, b in busy:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        ranges = [e for e in self.events if e.get("cat") in RANGE_CATS
                  and str(e.get("name", "")).startswith(prefix)
                  and e.get("name") != self.window_label]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (a + b) / 2
            inside = [e for e in ranges if e["ts"] <= mid <= e["ts"] + e["dur"]]
            label: Optional[str] = max(inside, key=lambda e: e["ts"])["name"] if inside else None
            out.append([label or "none", (b - a) / 1e6])
        return out
