#!/usr/bin/env python3
"""Where the flagship's training step spends its time, on one GPU.

Builds the flagship (224x300x3, latent 2000, seeded random weights;
--model-type KurtosisGlobal by default, KurtosisSingle or KLGaussian) on the
card and drives the combined train + score step that the
benchmark times (train/bench_step.py::train_score_step: uint8 batch in,
normalize, loss, backward, Adam update, per-frame z-scores) at batch 256:

  * --precision bfloat16 (default): bfloat16 parameters and compute with
    ``adam_lean``, as the JAX package's bench.py runs it;
  * --precision float32: float32 parameters (TF32 off) with ``adam``.

Measures the untraced step time over --steps steps (host clock, fenced by
torch.cuda.synchronize), then a torch.profiler trace of --traced further
steps: device time per kernel per step, the sum, and the device's busy and
idle share of the traced steps' wall time; then the optimizer's update
alone. Prints a summary and writes it as
JSON to --out (default build/profile_train.json, git-ignored).

Usage: python3 profile_train_torch.py [--precision bfloat16] [--model-type KurtosisSingle]
           [--steps 10] [--traced 3]
"""

import argparse
import json
import os
import subprocess
import sys
import time

from profile_stream_torch import analyze_trace

REPO = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--precision", default="bfloat16", choices=["bfloat16", "float32"])
    parser.add_argument("--model-type", default="KurtosisGlobal",
                        choices=["KurtosisGlobal", "KurtosisSingle", "KLGaussian"])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=10, help="untraced steps timed")
    parser.add_argument("--traced", type=int, default=3, help="steps under the profiler")
    parser.add_argument("--out", default=os.path.join(REPO, "build", "profile_train.json"))
    parser.add_argument("--trace", action="store_true", help="also write the Chrome trace")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_train_torch: no CUDA device", file=sys.stderr)
        return 1
    from trustedai_cl_vae_ad_tpu_torch.ops import moments
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.train.bench_step import flagship_config, train_score_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    config = flagship_config()
    config["training"]["precision"] = args.precision
    config["model"]["type"] = args.model_type
    model = load_model_from_config(config, seed=0, device="cuda")
    model.compile()
    w, h, c = config["data"]["image_size"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x_u8 = torch.randint(0, 256, (args.batch, w, h, c), dtype=torch.uint8, device="cuda",
                         generator=gen)
    summary = {"card": smi.splitlines()[0], "torch": torch.__version__,
               "model_type": args.model_type, "precision": args.precision,
               "optimizer": model.optimizer.name,
               "batch": args.batch,
               "parameters": sum(p.numel() for p in model.core.parameters())}

    def step():
        return train_score_step(model, x_u8, 100.0, 10.0)

    moments.build()
    for _ in range(3):
        loss, _z = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss, _z = step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    summary["step_ms"] = step_ms
    summary["frames_per_s"] = args.batch / (step_ms * 1e-3)
    summary["last_loss"] = float(loss)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(args.traced):
            with torch.profiler.record_function("step"):
                step()
                torch.cuda.synchronize()
    trace_path = os.path.splitext(args.out)[0] + "_trace.json"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    if not args.trace:
        os.remove(trace_path)
    summary["traced"] = analyze_trace(events, args.traced, frame_label="step")
    summary["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30

    # the optimizer's update alone, on gradients of the parameters' shapes
    grads = [torch.full_like(p, 1e-3) for p in model.optimizer.params]
    model.optimizer.step(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        model.optimizer.step(grads)
    torch.cuda.synchronize()
    summary["optimizer_alone_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    del grads

    tr = summary["traced"]
    print(f"{summary['card']}; torch {summary['torch']}; {summary['parameters']:,} parameters, "
          f"{args.model_type}, {args.precision}, {summary['optimizer']}, batch {args.batch}")
    print(f"untraced {args.steps} steps: {step_ms:.3f} ms/step, "
          f"{summary['frames_per_s']:.1f} frames/s, last loss {summary['last_loss']:.6f}")
    print(f"traced {args.traced} steps: wall {tr['window_ms_per_frame']:.3f} ms/step, "
          f"device kernels {tr['device_sum_ms_per_frame']:.3f} ms/step, "
          f"busy {tr['busy_share']:.1%}, idle {tr['idle_share']:.1%}")
    for r in tr["kernels"][:25]:
        print(f"  {r['ms_per_frame']:9.4f} ms  x{r['launches_per_frame']:<5g} {r['kernel']}")
    print("the moments kernels (csrc/moments_cluster.cu) in the traced steps:")
    names = ("global_forward_kernel", "perdim_forward_kernel", "global_backward_kernel",
             "perdim_backward_kernel")
    rows = [r for r in tr["kernels"] if any(k in r["kernel"] for k in names)]
    for r in rows:
        print(f"  {r['ms_per_frame']:9.4f} ms  x{r['launches_per_frame']:<5g} {r['kernel']}")
    summary["moments_kernels_ms"] = sum(r["ms_per_frame"] for r in rows)
    print(f"  together {summary['moments_kernels_ms']:.4f} ms a step")
    print(f"{summary['optimizer']} update alone: {summary['optimizer_alone_ms']:.3f} ms")
    print(f"peak device memory {summary['peak_device_GiB']:.2f} GiB")
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
