#!/usr/bin/env python3
"""CLI: headless live-stream anomaly detection on the PyTorch port.

The single-stream path of ``camera_streamer.py`` on the port
(``trustedai_cl_vae_ad_tpu_torch``): capture (RTSP / webcam / video file /
frame directory / synthetic) -> device inference + streaming anomaly score
-> optional continual learning (``-c``: a gradient step on the recent frames
[+ a replay buffer] at its own cadence; the next frame is scored with the
updated weights). The model comes from a log directory that
``train_torch.py`` wrote (``-m``; with ``-c`` its Adam moments are restored
too), or is built from a config with seeded random weights (``--config``).
Recording, autosave, multi-camera and int8 serving are not ported yet.

Usage:
  python camera_streamer_torch.py --config configs/config.yml --source synthetic --max-frames 64
  python camera_streamer_torch.py -m logs/fit_20260101-000000 --source synthetic --max-frames 64
  python camera_streamer_torch.py -m LOGDIR -c --learning-rate 1e-5 --replay-buffer replay.txt \
      --metrics-dir cl_metrics --source synthetic --max-frames 200
  python camera_streamer_torch.py cam_config.yml --config configs/config.yml --device cuda
"""

import argparse
import contextlib

import torch

from trustedai_cl_vae_ad_tpu_torch.registry import (
    load_model_from_config_path,
    load_model_from_directory,
)
from trustedai_cl_vae_ad_tpu_torch.stream.capture import make_source
from trustedai_cl_vae_ad_tpu_torch.stream.run import (
    StopRequest,
    build_engine,
    configure_continual_learning,
    parse_warmup_spec,
    resolve_camera,
    run_stream,
)
from trustedai_cl_vae_ad_tpu_torch.utils.metrics import MetricsWriter


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("cam_config", type=str, nargs="?", default=None,
                        help="cam_config.yml with camera_list + anomaly_settings")
    parser.add_argument("--cam-config-index", type=int, default=0)
    parser.add_argument("--model-dir", "-m", type=str, default=None,
                        help="Trained log directory written by train_torch.py "
                             "(config.yml, encoder/, decoder/)")
    parser.add_argument("--config", type=str, default=None,
                        help="Model config YAML (e.g. configs/config.yml): random weights")
    parser.add_argument("--init-seed", type=int, default=0,
                        help="Seed of the random initial weights")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; never falls back to cpu)")
    parser.add_argument("--source", "-s", type=str, default=None,
                        help="Override source: 'synthetic', dir, file, index, or URL")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--continual-learning", "-c", action="store_true")
    parser.add_argument("--learning-rate", type=float, default=None)
    parser.add_argument("--img-noise", type=float, default=None)
    parser.add_argument("--replay-buffer", type=str, default=None, help="txt/csv of image paths")
    parser.add_argument("--metrics-dir", type=str, default=None,
                        help="Write each CL epoch's losses and the anomaly scores to "
                             "<dir>/metrics.jsonl (and TensorBoard events)")
    parser.add_argument("--stats-jsonl", type=str, default=None, help="Write per-frame stats")
    parser.add_argument("--realtime", action="store_true",
                        help="Pace frames at source fps (default: as fast as possible)")
    parser.add_argument("--host-resize", action="store_true",
                        help="Shrink frames on the host before upload")
    parser.add_argument("--pipelined", action="store_true",
                        help="One-frame-lag pipelining: overlap fetch with compute")
    parser.add_argument("--warmup", nargs="?", const="native", default=None, metavar="HxW",
                        help="Build the kernels and run the dispatch (and with -c the "
                             "CL step's loss and backward) once before the "
                             "first frame; pass the camera resolution (e.g. 1080x1920) "
                             "or omit the value for the model's native size")
    args = parser.parse_args(argv)
    args.warmup = parse_warmup_spec(args.warmup, parser.error)
    if (args.model_dir is None) == (args.config is None):
        parser.error("give exactly one of -m/--model-dir and --config")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: CUDA is not available")
    return args


def main(argv=None):
    args = get_args(argv)
    stop = StopRequest()
    stop.install()

    anomaly_settings, cam_info, fps, source_spec = resolve_camera(
        args.cam_config, args.cam_config_index, args.source)
    if args.model_dir is not None:
        # a CL resume restores checkpointed Adam moments with the weights; an
        # inference-only stream allocates none
        model, config = load_model_from_directory(
            args.model_dir, device=args.device, restore_optimizer=args.continual_learning)
    else:
        model, config = load_model_from_config_path(args.config, seed=args.init_seed,
                                                    device=args.device)
    with contextlib.ExitStack() as stack:
        metrics = None
        if args.metrics_dir:
            metrics = stack.enter_context(MetricsWriter(args.metrics_dir))
        engine = build_engine(model, config, anomaly_settings=anomaly_settings,
                              realtime=args.realtime, cam_info=cam_info, metrics=metrics,
                              host_resize=args.host_resize, pipelined=args.pipelined)
        configure_continual_learning(
            engine, continual_learning=args.continual_learning,
            learning_rate=args.learning_rate, img_noise=args.img_noise,
            replay_buffer=args.replay_buffer, model_dir=args.model_dir)
        if args.warmup:
            spec = args.warmup
            if args.host_resize:
                spec = "native"  # host-resized frames reach the device at model size
            shape = None if spec == "native" else (*spec, engine.channels)
            print("warming up (building the kernels, running the dispatch"
                  + (" and the CL step's backward once)" if args.continual_learning
                     else " once)"))
            engine.warmup(frame_shape=shape, cl=args.continual_learning)
        source = make_source(source_spec, fps=fps)
        run_stream(engine, source, max_frames=args.max_frames, stats_jsonl=args.stats_jsonl,
                   realtime=args.realtime, fps=fps, stop=stop)
        if args.continual_learning:
            print(f"continual learning: {engine.cl_epochs} steps, last loss "
                  f"{(engine.last_epoch_loss or {}).get('loss')}")


if __name__ == "__main__":
    main()
