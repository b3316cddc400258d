#!/usr/bin/env python3
"""Where the flagship's live-stream frame spends its time, on one GPU.

Builds the flagship (configs/config.yml, KurtosisGlobal 224x300x3, latent
2000, seeded random weights) on the card through the same registry and
stream/run.py code as camera_streamer_torch.py, feeds it synthetic 240x320
frames (so the device resize runs), and measures, for one stream or, with
``--n-streams K``, for the multi-camera tick of K cameras, in float or, with
``--quantize``, with the large Dense kernels in int8 (``w8a8``):

  * host frame latency p50/p95 over --frames untraced frames;
  * a torch.profiler trace of --traced further frames: device time per
    kernel per frame, the sum, and the device's busy and idle share of the
    traced frames' wall time (the union of kernel and copy intervals);
  * the encoder's and the decoder's dense layer alone (F.linear at batch 1,
    CUDA events, median of 50) and the weight bandwidth each reaches (float
    runs only);
  * the host's resident memory after the imports, after the model is
    built, after the first frame and at the end, and the peak device memory.

Prints a summary and writes it as JSON to --out (default
build/profile_stream.json, git-ignored); --trace also writes the Chrome
trace beside it.

Usage: python3 profile_stream_torch.py [--frames 64] [--traced 20] [--trace]
           [--n-streams 16] [--quantize]
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def median_ms(fn, runs=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(runs)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def dense_alone(model):
    """The two dense layers' GEMVs at batch 1, each timed alone."""
    import torch
    import torch.nn.functional as F

    out = {}
    layers = (("encoder", model.core.encoder.layers[f"Dense_{model.core.encoder.n_dense}"]),
              ("decoder", model.core.decoder.layers["Dense_0"]))
    with torch.inference_mode():
        for name, dense in layers:
            x = torch.rand((1, dense.in_features), device=model.device)
            ms = median_ms(lambda: F.linear(x, dense.weight, dense.bias))
            nbytes = dense.weight.numel() * dense.weight.element_size()
            out[name] = {"shape": [dense.in_features, dense.out_features], "ms": ms,
                         "weight_GB": nbytes / 1e9, "TB_per_s": nbytes / (ms * 1e-3) / 1e12}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=os.path.join(REPO, "configs", "config.yml"))
    parser.add_argument("--frames", type=int, default=64, help="untraced frames timed")
    parser.add_argument("--traced", type=int, default=20, help="frames under the profiler")
    parser.add_argument("--out", default=os.path.join(REPO, "build", "profile_stream.json"))
    parser.add_argument("--trace", action="store_true", help="also write the Chrome trace")
    parser.add_argument("--n-streams", type=int, default=1,
                        help="cameras per tick; above 1 the multi-camera engine is profiled "
                             "and a 'frame' below is one tick of all of them")
    parser.add_argument("--quantize", action="store_true",
                        help="serve the large Dense kernels in int8 (w8a8)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_stream_torch: no CUDA device", file=sys.stderr)
        return 1
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine
    from trustedai_cl_vae_ad_tpu_torch.stream.run import build_engine, run_stream
    from trustedai_cl_vae_ad_tpu_torch.utils.profiling import rss_mb

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    summary = {"card": smi.splitlines()[0], "torch": torch.__version__,
               "streams": args.n_streams, "mode": "w8a8" if args.quantize else "float32",
               "rss_mb": {"after_imports": rss_mb()}}
    t0 = time.perf_counter()
    model, config = load_model_from_config_path(args.config, seed=0, device="cuda")
    torch.cuda.synchronize()
    summary["build_s"] = time.perf_counter() - t0
    summary["parameters"] = sum(p.numel() for p in model.core.parameters())
    summary["rss_mb"]["after_model"] = rss_mb()

    fleet = args.n_streams > 1
    if fleet:
        engine = MultiCameraEngine(model, config, n_streams=args.n_streams,
                                   quantize=args.quantize)
        step = engine.process_frames
    else:
        engine = build_engine(model, config, quantize=args.quantize)
        step = engine.process_frame
    engine.warmup(frame_shape=(240, 320, 3))
    summary["rss_mb"]["after_first_frame"] = rss_mb()
    torch.cuda.reset_peak_memory_stats()

    def ticks(n, seed):
        """n frames of one camera, or n ticks of --n-streams cameras."""
        if not fleet:
            return list(SyntheticSource(n_frames=n, seed=seed))
        cams = [list(SyntheticSource(n_frames=n, seed=seed + 100 * i))
                for i in range(args.n_streams)]
        return [list(tick) for tick in zip(*cams)]

    if fleet:
        lat = []
        for i, tick in enumerate(ticks(args.frames, 0)):
            t0 = time.perf_counter()
            step(tick, tag=i)  # the tick's score fetch waits for the device
            lat.append((time.perf_counter() - t0) * 1e3)
        kept = sorted(lat[2:] if len(lat) > 4 else lat)
        summary["latency_ms"] = {"p50_ms": kept[len(kept) // 2],
                                 "p95_ms": kept[min(len(kept) - 1, int(0.95 * len(kept)))],
                                 "mean_ms": sum(kept) / len(kept), "frames": len(lat)}
    else:
        stream = run_stream(engine, SyntheticSource(n_frames=args.frames, seed=0),
                            log=lambda m: None)
        summary["latency_ms"] = {k: stream[k] for k in ("p50_ms", "p95_ms", "mean_ms")}
        summary["latency_ms"]["frames"] = stream["frames"]

    frames = ticks(args.traced, 1)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for i, f in enumerate(frames):
            with torch.profiler.record_function("frame"):
                step(f, tag=i)
    trace_path = os.path.splitext(args.out)[0] + "_trace.json"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    if not args.trace:
        os.remove(trace_path)
    summary["traced"] = analyze_trace(events, len(frames))
    summary["dense_alone"] = {} if args.quantize else dense_alone(model)
    summary["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    summary["rss_mb"]["end"] = rss_mb()

    tr = summary["traced"]
    print(f"{summary['streams']} stream(s), {summary['mode']}; a frame below is one "
          f"{'tick of all streams' if fleet else 'frame'}")
    print(f"{summary['card']}; torch {summary['torch']}; "
          f"{summary['parameters']:,} parameters built in {summary['build_s']:.1f} s")
    lat = summary["latency_ms"]
    print(f"untraced {lat['frames']} frames: p50 {lat['p50_ms']:.3f} ms, "
          f"p95 {lat['p95_ms']:.3f} ms, mean {lat['mean_ms']:.3f} ms")
    print(f"traced {len(frames)} frames: wall {tr['window_ms_per_frame']:.3f} ms/frame, "
          f"device kernels {tr['device_sum_ms_per_frame']:.3f} ms/frame, "
          f"busy {tr['busy_share']:.1%}, idle {tr['idle_share']:.1%}")
    for r in tr["kernels"][:15]:
        print(f"  {r['ms_per_frame']:8.4f} ms  x{r['launches_per_frame']:<4g} {r['kernel']}")
    for name, d in summary["dense_alone"].items():
        print(f"{name} dense {d['shape'][0]}->{d['shape'][1]} alone: {d['ms']:.4f} ms, "
              f"{d['weight_GB']:.3f} GB of weights, {d['TB_per_s']:.3f} TB/s")
    print(f"peak device memory {summary['peak_device_GiB']:.2f} GiB; host RSS (MB) "
          + ", ".join(f"{k} {v:.0f}" for k, v in summary["rss_mb"].items()))
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
