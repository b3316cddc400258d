#!/usr/bin/env python3
"""The r11 probes on one GPU: one Adam step on one dense kernel, with the
gradient product fused in (``--harness fused``) and taken apart
(``--harness diag``).

Counterpart of ``benchmarks/r11_fused_dense_adam.py`` and
``benchmarks/r11_diag.py``; the variants and the record's keys are described
in ``trustedai_cl_vae_ad_tpu_torch/probes/r11.py``. Every kernel is the port's
own (``csrc/dense_grad_adam.cu``, and for bf16 on the tensor cores' rule
``csrc/dense_grad_wgmma.cu`` and ``csrc/dense_grad_adam_wgmma.cu``, built at
first use); the ``torch`` variant
is the yardstick (``torch.matmul`` and the plain epilogue).

  --harness fused   --shapes enc,dec[,enc4096]  --variants torch,fused
                    (the flagship's dense kernels at batch 768; a kernel
                    variant is first held against the plain version at a
                    reduced shape unless --no-check)
  --harness diag    --variants torch,fused,fused_xt,dot_only,copy_only,
                    epi_bf16,epi_only  [--N 4096] [--M ..] [--K ..]
                    (K=768, M=12800, N=4000 unless overridden)

Runs on the card unless ``--device cpu`` is given, which runs the plain
versions (use small --K/--M/--N there, with --harness diag). One JSON record
a line is printed and appended to --out (default build/probe_r11.jsonl,
git-ignored), with the card's name and power limit in each.

Usage: python3 probe_r11_torch.py [--harness fused] [--shapes enc,dec] [--variants torch,fused]
           [--steps 20] [--no-check] [--device cuda] [--seed 0] [--out FILE]
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--harness", default="fused", choices=["fused", "diag"])
    parser.add_argument("--shapes", default="enc,dec", help="harness fused: names of shapes")
    parser.add_argument("--variants", default=None,
                        help="default: torch,fused (fused); torch,fused,fused_xt,dot_only,"
                             "epi_only (diag)")
    parser.add_argument("--steps", type=int, default=None, help="default 20 (fused), 50 (diag)")
    parser.add_argument("--no-check", action="store_true")
    parser.add_argument("--K", type=int, default=None, help="harness diag: override K")
    parser.add_argument("--M", type=int, default=None, help="harness diag: override M")
    parser.add_argument("--N", type=int, default=None,
                        help="harness diag: override N (e.g. 4096, a multiple of 128)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=os.path.join(REPO, "build", "probe_r11.jsonl"))
    args = parser.parse_args(argv)

    import torch

    from trustedai_cl_vae_ad_tpu_torch.probes import r11

    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_r11_torch: no CUDA device (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 1
    fused = args.harness == "fused"
    if fused and (args.K or args.M or args.N):
        parser.error("--K, --M and --N belong to --harness diag; harness fused takes --shapes")
    variants = (args.variants or ("torch,fused" if fused else
                                  "torch,fused,fused_xt,dot_only,epi_only")).split(",")
    for v in variants:
        if v in r11.TPU_ONLY:
            parser.error(f"variant {v} {r11.TPU_ONLY[v]} and has no counterpart on a GPU")
    steps = args.steps or (20 if fused else 50)
    card = "cpu"
    if args.device == "cuda":
        from trustedai_cl_vae_ad_tpu_torch.registry import use_full_float32

        use_full_float32()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {card}", flush=True)
    if fused:
        unknown = [s for s in args.shapes.split(",") if s not in r11.SHAPES]
        if unknown:
            parser.error(f"unknown shapes {unknown} (expected some of {list(r11.SHAPES)})")
        jobs = [dict(shape_name=s) for s in args.shapes.split(",")]
    else:
        k, m, n = r11.DIAG_SHAPE
        jobs = [dict(shape=(args.K or k, args.M or m, args.N or n))]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for job in jobs:
        for variant in variants:
            rec, _state = r11.run(args.harness, variant, steps=steps, check=not args.no_check,
                                  device=args.device, seed=args.seed, **job)
            del _state
            rec["card"] = card
            print(json.dumps(rec), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
