#!/usr/bin/env python3
"""CLI: headless live-stream anomaly detection on the PyTorch port.

``camera_streamer.py`` on the port (``trustedai_cl_vae_ad_tpu_torch``):
capture (RTSP / webcam / video file / frame directory / synthetic) -> device
inference + streaming anomaly score -> optional continual learning (``-c``:
a gradient step on the recent frames [+ a replay buffer] at its own cadence;
the next frame is scored with the updated weights) -> optional recording
(``-r``: five PNG streams and a COCO labels.json of the scores, closed with a
model snapshot) -> autosave of the CL state into ``--model-cache-dir`` every
``--autosave-period-s`` (``--async-autosave`` writes in the background).
``--all-cameras`` batches every camera of the cam_config's camera_list (or
``--n-streams`` synthetic ones) into one device dispatch per tick, with
``-c`` one fleet CL step per period on the union of all streams' recent
frames. ``--quantize`` serves the large Dense kernels in int8; without
``-c`` it boots from ``<model-dir>/quantized`` when
``tools/quantize_checkpoint_torch.py`` has written one, and the float weights
then never reach the device. The model comes from a log directory that
``train_torch.py`` or an autosave wrote (``-m``; with ``-c`` its Adam
moments are restored too), or is built from a config with seeded random
weights (``--config``). ``--max-rss-mb`` saves the CL state and exits 3 for a
supervisor restart when the host's memory passes the limit;
``--combine-datasets`` merges recordings and exits. ``--mesh`` with
``--all-cameras`` splits the streams over every local CUDA device (the
device named by ``--device`` alone when it is not a CUDA device), in blocks
of K/D.

Usage:
  python camera_streamer_torch.py --config configs/config.yml --source synthetic --max-frames 64
  python camera_streamer_torch.py -m logs/fit_20260101-000000 -c --model-cache-dir model_cache \
      --record-dir recordings --async-autosave --source synthetic --max-frames 200
  python camera_streamer_torch.py -m LOGDIR -c --learning-rate 1e-5 --replay-buffer replay.txt \
      --metrics-dir cl_metrics --source synthetic --max-frames 200
  python camera_streamer_torch.py cam_config.yml --config configs/config.yml --device cuda
  python camera_streamer_torch.py --config configs/config.yml --all-cameras --n-streams 16 \
      --quantize --source synthetic --max-frames 64 --stats-jsonl ticks.jsonl
  python camera_streamer_torch.py --config configs/config.yml --all-cameras --n-streams 16 \
      --mesh -c --source synthetic --max-frames 64
  python camera_streamer_torch.py --combine-datasets rec/data_A rec/data_B --combine-dest merged
"""

import argparse
import contextlib
import os

import torch

from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import make_mesh
from trustedai_cl_vae_ad_tpu_torch.stream.capture import make_source
from trustedai_cl_vae_ad_tpu_torch.stream.engine import combine_datasets
from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine
from trustedai_cl_vae_ad_tpu_torch.stream.run import (
    RSS_EXIT_CODE,
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
                        help="Log directory written by train_torch.py or an autosave "
                             "(config.yml, encoder/, decoder/)")
    parser.add_argument("--config", type=str, default=None,
                        help="Model config YAML (e.g. configs/config.yml): random weights")
    parser.add_argument("--init-seed", type=int, default=0,
                        help="Seed of the random initial weights")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; never falls back to cpu)")
    parser.add_argument("--source", "-s", "--rtsp-override", "--rtsp-overide",
                        dest="source", type=str, default=None,
                        help="Override source: 'synthetic', dir, file, index, or URL "
                             "(--rtsp-override as the reference CLI spells it)")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--continual-learning", "-c", action="store_true")
    parser.add_argument("--learning-rate", type=float, default=None)
    parser.add_argument("--img-noise", type=float, default=None)
    parser.add_argument("--replay-buffer", type=str, default=None, help="txt/csv of image paths")
    parser.add_argument("--record-dir", "-r", type=str, default=None,
                        help="Record the five PNG streams and labels.json under this directory")
    parser.add_argument("--model-cache-dir", type=str, default="model_cache",
                        help="Where the CL state is autosaved")
    parser.add_argument("--metrics-dir", type=str, default=None,
                        help="Write each CL epoch's losses and the anomaly scores to "
                             "<dir>/metrics.jsonl (and TensorBoard events). Defaults to "
                             "<model-cache-dir>/metrics when CL is enabled.")
    parser.add_argument("--stats-jsonl", type=str, default=None,
                        help="Write per-frame (per-tick with --all-cameras) stats")
    parser.add_argument("--all-cameras", action="store_true",
                        help="Batch ALL cam_config camera_list streams into one device "
                             "dispatch per tick (MultiCameraEngine); with -c, fleet CL: one "
                             "gradient step per period on the union of all streams' "
                             "recent frames")
    parser.add_argument("--n-streams", type=int, default=None,
                        help="With --all-cameras and no cam_config: the number of "
                             "synthetic streams (default 2)")
    parser.add_argument("--combine-datasets", nargs="+", metavar="SRC",
                        help="Merge recorded dataset directories (their labels.json images "
                             "concatenated) into --combine-dest and exit")
    parser.add_argument("--combine-dest", type=str, default=None)
    parser.add_argument("--quantize", action="store_true",
                        help="int8-quantize the large Dense kernels for the inference "
                             "dispatch (ops/quant.py); continual learning keeps the float "
                             "parameters and quantizes again after each step")
    parser.add_argument("--autosave-period-s", type=float, default=5 * 60.0,
                        help="Seconds between scheduled model-cache saves")
    parser.add_argument("--async-autosave", action="store_true",
                        help="Write the periodic model-cache saves in the background: the "
                             "frame loop resumes after the device->host copy instead of "
                             "waiting for the disk (16 GB at the flagship with CL on)")
    parser.add_argument("--realtime", action="store_true",
                        help="Pace frames at source fps (default: as fast as possible)")
    parser.add_argument("--host-resize", action="store_true",
                        help="Shrink frames on the host before upload")
    parser.add_argument("--pipelined", action="store_true",
                        help="One-frame-lag pipelining: overlap fetch with compute")
    parser.add_argument("--mesh", action="store_true",
                        help="With --all-cameras on a multi-chip host: shard "
                             "the K streams over all local devices (stream "
                             "count must divide the device count)")
    parser.add_argument("--warmup", nargs="?", const="native", default=None, metavar="HxW",
                        help="Build the kernels and run the dispatch (and with -c the "
                             "CL step's loss and backward) once before the "
                             "first frame; pass the camera resolution (e.g. 1080x1920) "
                             "or omit the value for the model's native size")
    parser.add_argument("--max-rss-mb", type=float, default=None,
                        help="When the host's resident memory passes this many MB: save "
                             "the CL state to the model cache, end the run as usual and "
                             f"exit {RSS_EXIT_CODE}, so that a supervisor restarts the "
                             "process")
    args = parser.parse_args(argv)
    args.warmup = parse_warmup_spec(args.warmup, parser.error)
    if args.combine_datasets:
        if not args.combine_dest:
            parser.error("--combine-datasets requires --combine-dest")
        return args  # merging loads no model and needs no device
    if (args.model_dir is None) == (args.config is None):
        parser.error("give exactly one of -m/--model-dir and --config")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: CUDA is not available")
    return args


def main_all_cameras(args, model, config, qparams, metrics, stop):
    """Every camera of the list (or --n-streams synthetic ones) in one batched
    tick, with fleet CL, recording and autosave; returns the run's summary."""
    anomaly_settings, specs, names, fps_list = resolve_cameras(args.cam_config, args.n_streams)
    mesh = None
    if args.mesh:
        device = torch.device(args.device)
        mesh = make_mesh(devices=None if device.type == "cuda" else [device])
        print(f"mesh: {len(mesh.devices)} devices, {len(specs) // len(mesh.devices)} "
              "streams each")
    engine = MultiCameraEngine(model, config, n_streams=len(specs),
                               anomaly_settings=anomaly_settings, quantize=args.quantize,
                               pipelined=args.pipelined, mesh=mesh, qparams=qparams,
                               metrics=metrics,
                               model_cache_dir=args.model_cache_dir,
                               autosave_period_s=args.autosave_period_s,
                               async_autosave=args.async_autosave)
    configure_continual_learning(
        engine, continual_learning=args.continual_learning,
        learning_rate=args.learning_rate, img_noise=args.img_noise,
        replay_buffer=args.replay_buffer, model_dir=args.model_dir)
    if args.record_dir:
        os.makedirs(args.record_dir, exist_ok=True)
        engine.begin_recording(args.record_dir, names=names)
    if args.warmup:
        shape = None if args.warmup == "native" else (*args.warmup, engine.channels)
        print("warming up (building the kernels, running the tick"
              + (" and the fleet CL step's backward once)" if args.continual_learning
                 else " once)"))
        engine.warmup(frame_shape=shape, cl=args.continual_learning)
    summary = run_all_cameras(engine, make_paced_readers(specs, fps_list), names,
                              max_frames=args.max_frames, stats_jsonl=args.stats_jsonl,
                              realtime=args.realtime, fps=max(fps_list), stop=stop,
                              max_rss_mb=args.max_rss_mb)
    if args.continual_learning:
        print(f"fleet continual learning: {engine.cl_epochs} steps, last loss "
              f"{(engine.last_epoch_loss or {}).get('loss')}")
    return summary


def main(argv=None):
    args = get_args(argv)
    if args.combine_datasets:
        os.makedirs(args.combine_dest, exist_ok=True)
        out = combine_datasets(args.combine_datasets, args.combine_dest)
        print(f"Combined {len(args.combine_datasets)} datasets -> {out}")
        return
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
    metrics_dir = args.metrics_dir
    if metrics_dir is None and args.continual_learning:
        metrics_dir = os.path.join(args.model_cache_dir, "metrics")
    with contextlib.ExitStack() as stack:
        metrics = None
        if metrics_dir:
            metrics = stack.enter_context(MetricsWriter(metrics_dir))
        if args.all_cameras:
            summary = main_all_cameras(args, model, config, qparams, metrics, stop)
        else:
            summary = main_single_stream(args, model, config, qparams, metrics, stop,
                                         anomaly_settings, cam_info, fps, source_spec)
    if summary.get("rss_tripped"):
        raise SystemExit(RSS_EXIT_CODE)


def main_single_stream(args, model, config, qparams, metrics, stop, anomaly_settings,
                       cam_info, fps, source_spec):
    """One stream with continual learning, recording and autosave; returns
    the run's summary."""
    engine = build_engine(model, config, anomaly_settings=anomaly_settings,
                          realtime=args.realtime, cam_info=cam_info or config.get("cam_info"),
                          metrics=metrics, host_resize=args.host_resize,
                          pipelined=args.pipelined, quantize=args.quantize, qparams=qparams,
                          model_cache_dir=args.model_cache_dir,
                          autosave_period_s=args.autosave_period_s,
                          async_autosave=args.async_autosave)
    configure_continual_learning(
        engine, continual_learning=args.continual_learning,
        learning_rate=args.learning_rate, img_noise=args.img_noise,
        replay_buffer=args.replay_buffer, model_dir=args.model_dir)
    if args.record_dir:
        os.makedirs(args.record_dir, exist_ok=True)
        engine.begin_recording(args.record_dir)
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
    summary = run_stream(engine, source, max_frames=args.max_frames,
                         stats_jsonl=args.stats_jsonl, realtime=args.realtime, fps=fps,
                         stop=stop, max_rss_mb=args.max_rss_mb)
    if args.continual_learning:
        print(f"continual learning: {engine.cl_epochs} steps, last loss "
              f"{(engine.last_epoch_loss or {}).get('loss')}")
    return summary


if __name__ == "__main__":
    main()
