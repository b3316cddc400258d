#!/usr/bin/env python3
"""CLI: headless live-stream anomaly detection on the PyTorch port.

The single-stream path of ``camera_streamer.py`` on the port
(``trustedai_cl_vae_ad_tpu_torch``): capture (RTSP / webcam / video file /
frame directory / synthetic) -> device inference + streaming anomaly score.
The model is built from a config with seeded random weights; reading a
trained log directory (``-m``) waits for the port's checkpoint reader
(ROADMAP.md queue 1 item 8). Continual learning, recording, multi-camera and
int8 serving are not ported yet.

Usage:
  python camera_streamer_torch.py --config configs/config.yml --source synthetic --max-frames 64
  python camera_streamer_torch.py cam_config.yml --config configs/config.yml --device cuda
"""

import argparse

import torch

from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path
from trustedai_cl_vae_ad_tpu_torch.stream.capture import make_source
from trustedai_cl_vae_ad_tpu_torch.stream.run import (
    StopRequest,
    build_engine,
    parse_warmup_spec,
    resolve_camera,
    run_stream,
)


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("cam_config", type=str, nargs="?", default=None,
                        help="cam_config.yml with camera_list + anomaly_settings")
    parser.add_argument("--cam-config-index", type=int, default=0)
    parser.add_argument("--config", type=str, required=True,
                        help="Model config YAML (e.g. configs/config.yml)")
    parser.add_argument("--init-seed", type=int, default=0,
                        help="Seed of the random initial weights")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; never falls back to cpu)")
    parser.add_argument("--source", "-s", type=str, default=None,
                        help="Override source: 'synthetic', dir, file, index, or URL")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--stats-jsonl", type=str, default=None, help="Write per-frame stats")
    parser.add_argument("--realtime", action="store_true",
                        help="Pace frames at source fps (default: as fast as possible)")
    parser.add_argument("--host-resize", action="store_true",
                        help="Shrink frames on the host before upload")
    parser.add_argument("--pipelined", action="store_true",
                        help="One-frame-lag pipelining: overlap fetch with compute")
    parser.add_argument("--warmup", nargs="?", const="native", default=None, metavar="HxW",
                        help="Build the kernel and run the dispatch once before the "
                             "first frame; pass the camera resolution (e.g. 1080x1920) "
                             "or omit the value for the model's native size")
    args = parser.parse_args(argv)
    args.warmup = parse_warmup_spec(args.warmup, parser.error)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: CUDA is not available")
    return args


def main(argv=None):
    args = get_args(argv)
    stop = StopRequest()
    stop.install()

    anomaly_settings, _cam_info, fps, source_spec = resolve_camera(
        args.cam_config, args.cam_config_index, args.source)
    model, config = load_model_from_config_path(args.config, seed=args.init_seed,
                                                device=args.device)
    engine = build_engine(model, config, anomaly_settings=anomaly_settings,
                          realtime=args.realtime,
                          host_resize=args.host_resize, pipelined=args.pipelined)
    if args.warmup:
        spec = args.warmup
        if args.host_resize:
            spec = "native"  # host-resized frames reach the device at model size
        shape = None if spec == "native" else (*spec, engine.channels)
        print("warming up (building the kernel, running the dispatch once)")
        engine.warmup(frame_shape=shape)
    source = make_source(source_spec, fps=fps)
    run_stream(engine, source, max_frames=args.max_frames, stats_jsonl=args.stats_jsonl,
               realtime=args.realtime, fps=fps, stop=stop)


if __name__ == "__main__":
    main()
