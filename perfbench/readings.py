#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process.

    python3 perfbench/readings.py --workload <cell> --seeds 1 2 ... --seconds <s>
        [--control 3] [--out FILE]

For every seed: set-up and a window of ``--seconds`` as a run makes them (training
needs none: its readings come from set-up's steps; give 0), then each number compared
with the reference, from the program (the lower readings). For the first
``--control`` seeds also the control in the program's place: the reference with its
products in TF32, the precision below the configuration's float32; and, for a training
cell, the fault of a step on half of each batch, planted in the reference. One JSON
line a seed, each variant's numbers, to standard output and ``--out``. The benchmark's
own runs do not run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != here]
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    print(harness.card_line(), flush=True)
    cell = harness.load_cell(ROOT, args.workload)
    driver = harness.driver_of(cell)
    faults = ("half_batch",) if cell.traffic["driver"] == "train_steps" else ()
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        state = driver.setup(cell, seed, "cuda")
        window = driver.window(state, args.seconds)
        variants = ("program",) + (("control",) + faults if i < args.control else ())
        numbers = driver.check(state, variants)
        line = {"workload": cell.name, "seed": seed, "attempted": window.attempted,
                "seconds": time.perf_counter() - t0, **numbers}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
