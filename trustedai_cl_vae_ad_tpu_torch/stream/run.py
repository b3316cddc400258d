"""The single-stream loop shared by ``camera_streamer_torch.py`` and
``chip_smoke.py``.

Counterpart of the single-stream path of ``camera_streamer.py``'s ``main``:
build the engine, iterate a frame source, write per-frame stats as JSON
lines, stop at a tick boundary on SIGTERM/SIGINT, and summarize latency.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Callable, List, Optional

import numpy as np

from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine, load_cam_config
from trustedai_cl_vae_ad_tpu_torch.utils.profiling import rss_mb


class StopRequest:
    """SIGTERM/SIGINT stop request, consumed by ``run_stream`` at tick
    boundaries. The handler only records the signal; a second signal raises
    KeyboardInterrupt at once (the tick in flight is lost, deliberately)."""

    def __init__(self):
        self.count = 0

    def install(self) -> None:
        signal.signal(signal.SIGTERM, self._handle)
        signal.signal(signal.SIGINT, self._handle)

    def _handle(self, _sig, _frame) -> None:
        self.count += 1
        if self.count >= 2:
            raise KeyboardInterrupt


def resolve_camera(cam_config_path: Optional[str], index: int = 0,
                   source_spec: Optional[str] = None):
    """(anomaly_settings, cam_info, fps, source_spec) from an optional
    cam_config; the source defaults to the camera's url, then 'synthetic'."""
    anomaly_settings = None
    cam_info = None
    fps = 20.0
    if cam_config_path:
        cam_config = load_cam_config(cam_config_path, index)
        anomaly_settings = cam_config.get("anomaly_settings")
        cam_info = cam_config["camera_list"][index]
        fps = float(cam_info.get("fps", 20))
        if source_spec is None:
            source_spec = cam_info.get("url")
    if source_spec is None:
        source_spec = "synthetic"
    return anomaly_settings, cam_info, fps, source_spec


def parse_warmup_spec(value, error):
    """--warmup value -> (H, W) | "native" | None; ``error`` is the argparse
    usage-error callback."""
    if value and value != "native":
        try:
            h, w = (int(x) for x in value.lower().split("x"))
            return (h, w)
        except ValueError:
            error(f"--warmup expects HxW (got {value!r})")
    return value


def build_engine(model, config: dict, anomaly_settings=None, realtime: bool = False,
                 **engine_kwargs) -> StreamingEngine:
    engine = StreamingEngine(model, config, anomaly_settings=anomaly_settings,
                             **engine_kwargs)
    if not realtime:
        # offline replay: process every frame, ignore the wall-clock hold-off
        engine.inference_period_ms = 0.0
    return engine


def configure_continual_learning(engine: StreamingEngine, continual_learning: bool = False,
                                 learning_rate: Optional[float] = None,
                                 img_noise: Optional[float] = None,
                                 replay_buffer: Optional[str] = None,
                                 model_dir: Optional[str] = None, log: Callable = print) -> None:
    """The CLI's continual-learning controls, with ``camera_streamer.py``'s
    rules: a learning rate without CL is ignored (dialing it would allocate
    Adam's moments, which an inference-only stream never uses); a
    ``replay_buffer_paths.csv`` in the model directory is picked up, and an
    explicit replay file replaces it."""
    engine.enable_cont_learning = bool(continual_learning)
    if learning_rate is not None:
        if continual_learning:
            engine.set_learning_rate(learning_rate)
        else:
            log("--learning-rate ignored without --continual-learning")
    if img_noise is not None:
        engine.set_img_noise(img_noise)
    if model_dir is not None:
        recorded = os.path.join(model_dir, "replay_buffer_paths.csv")
        if os.path.exists(recorded):
            engine.load_replay_buffer_from_file(recorded)
    if replay_buffer:
        engine.load_replay_buffer_from_file(replay_buffer)


def _stats_line(result, lat_ms: float) -> dict:
    return {
        "frame": result.tag,
        "score": result.score,
        "score_ma": result.score_ma,
        "count": result.pixel_count,
        "anomalous": result.anomalous,
        "latency_ms": round(lat_ms, 3),
        "cl_stepped": result.cl_stepped,
    }


def run_stream(engine: StreamingEngine, source, max_frames: Optional[int] = None,
               stats_jsonl: Optional[str] = None, realtime: bool = False,
               fps: float = 20.0, stop: Optional[StopRequest] = None,
               on_result: Optional[Callable] = None, log: Callable = print,
               clock: Optional[Callable[[int], float]] = None) -> dict:
    """Feed ``source`` through ``engine`` until it ends, ``max_frames`` frames
    were submitted, or ``stop`` is requested. ``clock(n)`` gives frame n's
    time in seconds where a recorded stream is replayed on its own timeline
    (the hold-off, the CL cadence and the anomaly hold then follow it, not
    the wall clock). Per-frame latency is host time
    around ``process_frame``, whose host fetch of the score waits for the
    device. Returns a summary: frames submitted, results, latencies (ms),
    p50/p95/mean over the latencies after the first two when there are more
    than four; and the host's resident memory at the end (MB)."""
    stats_file = open(stats_jsonl, "w") if stats_jsonl else None
    n = 0
    n_results = 0
    latencies: List[float] = []
    try:
        for frame in source:
            if stop is not None and stop.count:
                raise KeyboardInterrupt
            t0 = time.perf_counter()
            result = engine.process_frame(frame, now=None if clock is None else clock(n), tag=n)
            if result is not None:
                lat_ms = (time.perf_counter() - t0) * 1000.0
                latencies.append(lat_ms)
                n_results += 1
                line = _stats_line(result, lat_ms)
                if on_result is not None:
                    on_result(result)
                if stats_file:
                    stats_file.write(json.dumps(line) + "\n")
                if n % 20 == 0 or result.anomalous:
                    log(f"frame {line['frame']}: AS={result.score: .4f} MA={result.score_ma: .4f} "
                        f"{'**ANOMALOUS**' if result.anomalous else ''} ({lat_ms:.2f} ms)")
            n += 1
            if max_frames is not None and n >= max_frames:
                break
            if realtime:
                time.sleep(max(0.0, 1.0 / fps - (time.perf_counter() - t0)))
    except KeyboardInterrupt:
        log("Keyboard Interrupt")
    finally:
        source.release()
        try:
            last = engine.flush() if engine.pipelined else None
            if last is not None:
                n_results += 1
                if on_result is not None:
                    on_result(last)
                if stats_file:
                    stats_file.write(json.dumps({"frame": last.tag, "score": last.score,
                                                 "score_ma": last.score_ma,
                                                 "flushed": True}) + "\n")
        finally:
            if stats_file:
                stats_file.close()
    summary = {"frames": n, "results": n_results, "latencies_ms": latencies,
               "rss_mb": rss_mb()}
    if latencies:
        lat = np.array(latencies[2:] if len(latencies) > 4 else latencies)
        summary.update(p50_ms=float(np.percentile(lat, 50)),
                       p95_ms=float(np.percentile(lat, 95)), mean_ms=float(lat.mean()))
        log(f"processed {n} frames; latency p50={summary['p50_ms']:.2f} ms "
            f"p95={summary['p95_ms']:.2f} ms mean={summary['mean_ms']:.2f} ms; "
            f"host RSS {summary['rss_mb']:.0f} MB")
    return summary
