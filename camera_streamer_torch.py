#!/usr/bin/env python3
"""CLI: headless live-stream anomaly detection on the PyTorch port.

``camera_streamer.py`` on the port (``trustedai_cl_vae_ad_tpu_torch``):
capture (RTSP / webcam / video file / frame directory / synthetic) -> device
inference + streaming anomaly score -> optional continual learning (``-c``:
a gradient step on the recent frames [+ a replay buffer] at its own cadence;
the next frame is scored with the updated weights). ``--all-cameras`` batches
every camera of the cam_config's camera_list (or ``--n-streams`` synthetic
ones) into one device dispatch per tick. ``--quantize`` serves the large
Dense kernels in int8; without ``-c`` it boots from ``<model-dir>/quantized``
when ``tools/quantize_checkpoint_torch.py`` has written one, and the float
weights then never reach the device. The model comes from a log directory
that ``train_torch.py`` wrote (``-m``; with ``-c`` its Adam moments are
restored too), or is built from a config with seeded random weights
(``--config``). Recording, autosave, and continual learning across a fleet
of cameras are not ported yet.

Usage:
  python camera_streamer_torch.py --config configs/config.yml --source synthetic --max-frames 64
  python camera_streamer_torch.py -m logs/fit_20260101-000000 --source synthetic --max-frames 64
  python camera_streamer_torch.py -m LOGDIR -c --learning-rate 1e-5 --replay-buffer replay.txt \
      --metrics-dir cl_metrics --source synthetic --max-frames 200
  python camera_streamer_torch.py cam_config.yml --config configs/config.yml --device cuda
  python camera_streamer_torch.py --config configs/config.yml --all-cameras --n-streams 16 \
      --quantize --source synthetic --max-frames 64 --stats-jsonl ticks.jsonl
"""

import argparse
import contextlib

import torch

from trustedai_cl_vae_ad_tpu_torch.stream.capture import make_source
from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine
from trustedai_cl_vae_ad_tpu_torch.stream.run import (
    StopRequest,
    build_engine,
    configure_continual_learning,
    load_serving_model,
    make_paced_readers,
    parse_warmup_spec,
    resolve_camera,
    resolve_cameras,
    run_all_cameras,
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
    parser.add_argument("--stats-jsonl", type=str, default=None,
                        help="Write per-frame (per-tick with --all-cameras) stats")
    parser.add_argument("--all-cameras", action="store_true",
                        help="Batch ALL cam_config camera_list streams into one device "
                             "dispatch per tick (MultiCameraEngine)")
    parser.add_argument("--n-streams", type=int, default=None,
                        help="With --all-cameras and no cam_config: the number of "
                             "synthetic streams (default 2)")
    parser.add_argument("--quantize", action="store_true",
                        help="int8-quantize the large Dense kernels for the inference "
                             "dispatch (ops/quant.py); continual learning keeps the float "
                             "parameters and quantizes again after each step")
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


def main_all_cameras(args, model, config, qparams, stop):
    """Every camera of the list (or --n-streams synthetic ones) in one batched
    tick; the engine's unported controls (-c, a replay buffer) raise."""
    anomaly_settings, specs, names, fps_list = resolve_cameras(args.cam_config, args.n_streams)
    engine = MultiCameraEngine(model, config, n_streams=len(specs),
                               anomaly_settings=anomaly_settings, quantize=args.quantize,
                               pipelined=args.pipelined, qparams=qparams)
    engine.enable_cont_learning = args.continual_learning
    if args.learning_rate is not None:
        print("--learning-rate ignored without --continual-learning")
    if args.replay_buffer:
        engine.load_replay_buffer_from_file(args.replay_buffer)
    if args.warmup:
        shape = None if args.warmup == "native" else (*args.warmup, engine.channels)
        print("warming up (building the kernels, running the tick once)")
        engine.warmup(frame_shape=shape)
    run_all_cameras(engine, make_paced_readers(specs, fps_list), names,
                    max_frames=args.max_frames, stats_jsonl=args.stats_jsonl,
                    realtime=args.realtime, fps=max(fps_list), stop=stop)


def main(argv=None):
    args = get_args(argv)
    stop = StopRequest()
    stop.install()

    anomaly_settings, cam_info, fps, source_spec = resolve_camera(
        args.cam_config, args.cam_config_index, args.source)
    # a CL resume restores checkpointed Adam moments with the weights; an
    # inference-only stream allocates none, and with --quantize it boots from
    # the int8 sidecar when the model directory holds one
    model, config, qparams = load_serving_model(
        args.model_dir, args.config, args.device, quantize=args.quantize,
        continual_learning=args.continual_learning, init_seed=args.init_seed)
    with contextlib.ExitStack() as stack:
        metrics = None
        if args.metrics_dir:
            metrics = stack.enter_context(MetricsWriter(args.metrics_dir))
        if args.all_cameras:
            return main_all_cameras(args, model, config, qparams, stop)
        engine = build_engine(model, config, anomaly_settings=anomaly_settings,
                              realtime=args.realtime, cam_info=cam_info, metrics=metrics,
                              host_resize=args.host_resize, pipelined=args.pipelined,
                              quantize=args.quantize, qparams=qparams)
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
