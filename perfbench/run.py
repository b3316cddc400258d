#!/usr/bin/env python3
"""Run one cell of the benchmark of ``trustedai_cl_vae_ad_tpu_torch`` on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It makes the inputs and the weights from the seed, sets
the program up (counted as ``setup_s``, from the start of this process), measures for
``--seconds``, then checks what the timed path produced against the plain reference
under ``perfbench/reference/``. ``--trace 1`` adds a profiled stretch after the
window and prints the cell's per-layer metrics instead of its end-to-end ones. The
last line on standard output is one JSON object: correct, attempted, failed,
metrics, device[, breakdown], checks. Without a CUDA device it exits 2 and prints no
result. README.md beside this file says how to add a cell.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--workload", required=True, help="a name in BENCHMARK.json's workloads")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True, help="length of the window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the checkout's root, not this folder, is where packages are found: the folder's
    # files are reached as perfbench.* and the program as trustedai_cl_vae_ad_tpu_torch
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != here]
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    return harness.main(args, ROOT, T_START)


if __name__ == "__main__":
    sys.exit(main())
