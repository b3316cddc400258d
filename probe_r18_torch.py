#!/usr/bin/env python3
"""The r18 probe on one GPU: the weight gradient of the encoder's stride-2 3x3
convolutions by the port's own kernel (``csrc/conv_dw.cu``, built at first
use), alone and inside the flagship train + score step.

Counterpart of ``benchmarks/r18_conv_dw.py``; the modes and the records' keys
are described in ``trustedai_cl_vae_ad_tpu_torch/probes/r18.py``.

  --check    the kernel and both gradients through its autograd Function
             against autograd of the same convolution at two small shapes;
             prints ``check ok``
  --kernel   the kernel alone at the flagship's conv1 and conv2, bfloat16,
             beside its bound and cuDNN's weight gradient (``library_ms``: a
             yardstick that only this script calls)
  --bench    the flagship KurtosisGlobal train + score step (bfloat16,
             adam_lean) with 0, 1 and 2 encoder convolutions routed through
             the kernel; the three variants' losses after one update must
             agree before anything is timed

Runs on the card unless ``--device cpu`` is given, which runs the plain
version (``--check`` at its own small shapes; ``--tiny --batch 4`` rehearses
the other modes there at a 32x48 model). One JSON record a line is printed and appended to --out
(default build/probe_r18.jsonl, git-ignored), with the card's name and power
limit in each.

Usage: python3 probe_r18_torch.py [--check] [--kernel] [--bench] [--batch 768] [--steps 20]
           [--tiny] [--device cuda] [--seed 0] [--out FILE]
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def cudnn_weight_gradient(x, dy):
    """The call that takes the library's weight gradient of the same
    convolution, (CO, CI, 3, 3): the yardstick of ``--kernel``. x, dy NHWC as
    the kernel takes them; the padding is done here, once, outside what is
    timed (in the model the forward has already made the padded input)."""
    import torch

    xpad = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
    dy_nchw = dy.permute(0, 3, 1, 2)
    weight = torch.empty((dy.shape[3], x.shape[3], 3, 3), dtype=x.dtype, device=x.device)
    return lambda: torch.ops.aten.convolution_backward(
        dy_nchw, xpad, weight, None, [2, 2], [0, 0], [1, 1], False, [0, 0], 1,
        [False, True, False])[1]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--kernel", action="store_true")
    parser.add_argument("--bench", action="store_true")
    parser.add_argument("--batch", type=int, default=768,
                        help="default 768; every training number of PERF.md is at 256")
    parser.add_argument("--steps", type=int, default=None, help="default 20 (bench), 10 (kernel)")
    parser.add_argument("--tiny", action="store_true",
                        help="rehearse --kernel and --bench at a tiny size (for --device cpu)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=os.path.join(REPO, "build", "probe_r18.jsonl"))
    args = parser.parse_args(argv)
    if not (args.check or args.kernel or args.bench):
        parser.error("give at least one of --check, --kernel, --bench")
    if args.batch < 1 or (args.steps is not None and args.steps < 1):
        parser.error("--batch and --steps must be at least 1")

    import torch

    from trustedai_cl_vae_ad_tpu_torch.probes import r18

    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_r18_torch: no CUDA device (--device cpu runs the plain version)",
              file=sys.stderr)
        return 1
    card = "cpu"
    if args.device == "cuda":
        from trustedai_cl_vae_ad_tpu_torch.registry import use_full_float32

        use_full_float32()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {card}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def emit(rows):
        for row in rows:
            row["card"] = card
            print(json.dumps(row), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    if args.check:
        emit(r18.check(device=args.device, seed=args.seed))
        print("check ok", flush=True)
    if args.kernel:
        emit(r18.kernel_only(batch=args.batch, steps=args.steps or 10, device=args.device,
                             seed=args.seed, library=cudnn_weight_gradient,
                             shapes=r18.TINY_SHAPES if args.tiny else None))
    if args.bench:
        emit(r18.bench(batch=args.batch, steps=args.steps or 20, device=args.device,
                       seed=args.seed, config=r18.tiny_bench_config() if args.tiny else None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
