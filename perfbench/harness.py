"""The benchmark's driver: finds a cell's files by name, runs it, prints the result.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Everything that belongs to
one configuration, traffic mix or per-layer metric sits in files of its own, found by
the names there:

  * ``configs[].file``: the configuration, as the program reads it (YAML);
  * ``perfbench/traffic/<traffic>.json``: the mix's parameters; its ``driver`` names
    the general generator under ``perfbench/drivers/`` that reads them;
  * ``perfbench/metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
    which returns a number or None (then the metric is left out of the line); where
    that file is not there, the family's ``<metric up to its first dot>.py`` serves
    (``conv_ms.py`` reads ``conv_ms.train`` and ``conv_ms.tick``);
  * ``perfbench/cells/<workload>.json``: the limit of each number that decides
    ``correct``.

A driver module provides ``setup(cell, seed, device)``, ``window(state, seconds)``,
``traced(state)`` and ``check(state, variants)``; see ``drivers/train_steps.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

#: top-level module names that may not be loaded in a run: JAX, and the JAX package and
#: its archived benchmarks (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "trustedai_cl_vae_ad_tpu", "src",
             "benchmarks")
#: every range the benchmark puts into a trace starts with this
RANGE_PREFIX = "pb."
WINDOW_RANGE = "pb.window"


@dataclass
class Cell:
    name: str
    root: Path
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


@dataclass
class Window:
    """What a driver's measured window gives: the end-to-end values it measured (by
    metric name), the work attempted and failed."""
    values: Dict[str, float]
    attempted: int
    failed: int


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    import yaml

    root = Path(root)
    spec = _read_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = yaml.safe_load(f)
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    limits = _read_json(root / "perfbench" / "cells" / f"{name}.json")["limits"]
    return Cell(name=name, root=root, config=config,
                traffic=_read_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json"),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                limits={k: float(v) for k, v in limits.items()})


def driver_of(cell: Cell):
    return importlib.import_module(f"perfbench.drivers.{cell.traffic['driver']}")


def load_reader(root: Path, metric: str):
    """``read`` of ``perfbench/metrics/<metric>.py``, or of its family's file,
    ``<metric up to its first dot>.py``, where the metric has none of its own."""
    folder = Path(root) / "perfbench" / "metrics"
    path = folder / f"{metric}.py"
    if not path.is_file():
        path = folder / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + "".join(ch if ch.isalnum() else "_" for ch in metric), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Context:
    """What a per-layer reader reads: the traced stretch, the cell's sizes, and what the
    run's measured window gave by the host's clock (by name, the end-to-end metrics'
    and the driver's other readings, such as a fleet's ``tick_ms_p95``)."""
    trace: object           # yardstick.trace.Trace
    config: dict
    traffic: dict
    frames_per_step: int
    window: Dict[str, float]


def read_trace(prof, steps: int):
    """The profiler's events as a ``yardstick.trace.Trace``; the Chrome trace passes
    through a temporary file under TMPDIR, deleted once read."""
    from perfbench.yardstick.trace import Trace

    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, steps, WINDOW_RANGE)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name, the device count and the card's power limit."""
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = [f"nvidia-smi failed: {exc}"]
    return (f"card: {torch.cuda.get_device_name(0)}; devices {torch.cuda.device_count()}; "
            f"nvidia-smi: {smi[0] if smi else 'no output'}")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """Set up, measure, check; returns the result line's object (without the import
    check, which the caller makes once everything has run)."""
    import torch

    driver = driver_of(cell)
    t_setup = time.perf_counter()
    state = driver.setup(cell, seed, device)
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    t_window = time.perf_counter()
    win = driver.window(state, seconds)
    values = dict(win.values, setup_s=setup_s)
    t_trace = time.perf_counter()
    traced = driver.traced(state) if trace else None
    memory_peak = 0 if device == "cpu" else max(state.memory_peak,
                                                torch.cuda.max_memory_allocated())
    t_check = time.perf_counter()
    numbers = driver.check(state)["program"]
    print(f"perfbench: set-up {setup_s:.3f} s ({t_setup - t_start:.3f} s before the "
          f"driver's), window {t_trace - t_window:.3f} s, traced {t_check - t_trace:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    # a number that is not finite (a NaN on one side only) fails, and prints as null
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None, "limit": lim}
              for k, lim in cell.limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        trace_obj, frames = traced
        ctx = Context(trace_obj, cell.config, cell.traffic, frames, values)
        for m in cell.per_layer:
            value = load_reader(cell.root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(win.attempted), "failed": int(win.failed),
           "metrics": metrics}
    if device == "cpu":
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                         "memory_peak_bytes": 0}
    else:
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": int(cell.chips), "memory_peak_bytes": int(memory_peak)}
    if trace:
        out["device"].update(busy_s=trace_obj.busy_s, window_s=trace_obj.window_s)
        out["breakdown"] = {"device_ops": trace_obj.top_device_ops(),
                            "idle_gaps": trace_obj.idle_gaps(RANGE_PREFIX)}
    out["checks"] = checks  # last: the numbers compared, each beside its limit
    return out


def main(args, root: Path, t_start: float) -> int:
    import torch

    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
