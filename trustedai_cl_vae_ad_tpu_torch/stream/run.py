"""The run loops shared by ``camera_streamer_torch.py`` and ``chip_smoke.py``.

Counterpart of ``camera_streamer.py``'s ``main`` (one stream) and
``run_all_cameras`` (every camera of a list batched into one tick): build
the engine, iterate the frame sources, write per-frame or per-tick stats as
JSON lines, stop at a tick boundary on SIGTERM/SIGINT or when the host's
resident memory passes ``max_rss_mb`` (after saving the continual-learning
state), and end every run in the same order: flush, close the recording,
drain the background autosave. Each loop returns a summary of its latencies.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from trustedai_cl_vae_ad_tpu_torch.stream.capture import make_source
from trustedai_cl_vae_ad_tpu_torch.stream.engine import (
    StreamingEngine,
    boot_serving_model,
    load_cam_config,
)
from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine
from trustedai_cl_vae_ad_tpu_torch.utils.profiling import rss_mb

#: exit code of a --max-rss-mb stop, apart from the error exits, so that a
#: supervisor restarts the process instead of treating it as a crash
RSS_EXIT_CODE = 3
#: the host's resident memory is read every this many frames or ticks
RSS_POLL_TICKS = 25


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


def configure_continual_learning(engine, continual_learning: bool = False,
                                 learning_rate: Optional[float] = None,
                                 img_noise: Optional[float] = None,
                                 replay_buffer: Optional[str] = None,
                                 model_dir: Optional[str] = None, log: Callable = print) -> None:
    """The CLI's continual-learning controls of either engine (one stream or
    the fleet), with ``camera_streamer.py``'s rules: a learning rate without CL is ignored (dialing it would allocate
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


def drain_then_save(engine, log: Callable = print, save_if_dirty: bool = False) -> None:
    """Drain the engine's background autosave, then save synchronously to
    the model cache if the drain failed (the engine has marked the model
    dirty again: the CL state of the failed round would be lost) or, with
    ``save_if_dirty``, whenever the model is dirty. The drain comes first:
    a save must not race the background writer over the same rounds."""
    try:
        engine.drain_autosaves()
        drained = True
    except Exception as e:  # noqa: BLE001: the save below must still run
        log(f"autosave drain failed: {e!r}")
        drained = False
    if engine.model_cache_dir and engine.model_changed_flag and (save_if_dirty or not drained):
        try:
            engine.save_model_to_dir(engine.model_cache_dir)
            engine.model_changed_flag = False
        except Exception as e:  # noqa: BLE001: a boundary that reports and ends
            log(f"saving to the model cache failed: {e!r}")


def close_run(engine, log: Callable = print) -> None:
    """The end of a run after the flush: close the recording (labels and the
    model snapshot), then drain the background autosave (``drain_then_save``),
    each guarded so that one failure does not skip the next."""
    if engine.recording_flag:
        try:
            engine.terminate_recording()
        except Exception as e:  # noqa: BLE001: the drain below must still run
            log(f"closing the recording failed: {e!r}")
    drain_then_save(engine, log)


def rss_guard_tripped(engine, n: int, max_rss_mb: Optional[float],
                      log: Callable = print) -> bool:
    """The --max-rss-mb poll, every ``RSS_POLL_TICKS`` frames or ticks: when
    the host's resident memory passes the limit, save dirty CL state to the
    model cache (``drain_then_save``) and report the trip; the caller then
    ends the run as usual and exits ``RSS_EXIT_CODE``."""
    if not max_rss_mb or n % RSS_POLL_TICKS != 0:
        return False
    rss = rss_mb()
    if rss <= max_rss_mb:
        return False
    log(f"host RSS {rss:.0f} MB exceeded --max-rss-mb {max_rss_mb:.0f}: saving state and "
        f"exiting {RSS_EXIT_CODE} for a supervisor restart")
    drain_then_save(engine, log, save_if_dirty=True)
    return True


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
               clock: Optional[Callable[[int], float]] = None,
               max_rss_mb: Optional[float] = None) -> dict:
    """Feed ``source`` through ``engine`` until it ends, ``max_frames`` frames
    were submitted, ``stop`` is requested or the rss guard trips
    (``rss_guard_tripped``; the summary's ``rss_tripped``); then flush,
    close the recording and drain the autosave (``close_run``). ``clock(n)``
    gives frame n's time in seconds where a recorded stream is replayed on its own timeline
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
    rss_tripped = False
    try:
        for frame in source:
            if stop is not None and stop.count:
                raise KeyboardInterrupt
            if rss_guard_tripped(engine, n, max_rss_mb, log):
                rss_tripped = True
                break
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
        except Exception as e:  # noqa: BLE001: the recording and the drain must still close
            log(f"flush failed: {e!r}")
        try:
            close_run(engine, log)
        finally:
            if stats_file:
                stats_file.close()
    summary = {"frames": n, "results": n_results, "latencies_ms": latencies,
               "rss_mb": rss_mb(), "rss_tripped": rss_tripped}
    if latencies:
        lat = np.array(latencies[2:] if len(latencies) > 4 else latencies)
        summary.update(p50_ms=float(np.percentile(lat, 50)),
                       p95_ms=float(np.percentile(lat, 95)), mean_ms=float(lat.mean()))
        log(f"processed {n} frames; latency p50={summary['p50_ms']:.2f} ms "
            f"p95={summary['p95_ms']:.2f} ms mean={summary['mean_ms']:.2f} ms; "
            f"host RSS {summary['rss_mb']:.0f} MB")
    return summary


# -- every camera of a list in one batched tick ---------------------------------------

class _LiveDrainThread:
    """Reads a live source continuously on a daemon thread and keeps only the
    newest frame. A capture FIFO backs up when it is read slower than the
    camera delivers, and a blocking read in the tick loop would throttle the
    whole fleet to the slowest camera; the reader thread absorbs both."""

    def __init__(self, source):
        self.source = source
        self._lock = threading.Lock()
        self._latest = None
        self._stop = False
        self.dead = False  # set when the source is exhausted or the read raises
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        try:
            while not self._stop and not self.source.exhausted:
                f = self.source.read()  # blocks until the camera's next frame
                if f is not None:
                    with self._lock:
                        self._latest = f
        except Exception as e:  # noqa: BLE001: a boundary that must report and end
            # a silently dead drain thread would hand out one frozen frame forever
            print(f"camera drain thread died: {e}")
        finally:
            self.dead = True

    def read(self):
        if self.dead:
            return None  # an exhausted or failed source ends the stream
        with self._lock:
            return self._latest  # the newest frame; never blocks the tick

    def stop(self) -> bool:
        """Signal the loop and join (bounded). Returns whether the thread has
        exited: the caller must NOT release the capture while a read may
        still be in flight on this thread."""
        self._stop = True
        self._thread.join(timeout=2.0)
        return not self._thread.is_alive()


class PacedReader:
    """Reads a source at its own fps relative to the batched tick rate.

    The multi-camera tick runs at the fastest camera's fps. A slower
    REPLAYABLE source (file, directory, synthetic) is read only on the ticks
    where a new frame is due (a fractional accumulator, deterministic) and
    repeats its latest frame in between, so mixed-fps camera lists do not
    drain the slower sources early. LIVE sources (``source.is_live``) are
    read on a drain thread instead, so the tick always gets the newest frame
    without waiting for any camera.
    """

    def __init__(self, source, fps: float, tick_fps: float):
        self.source = source
        self._ratio = min(max(fps, 1e-6) / max(tick_fps, 1e-6), 1.0)
        self._acc = 0.0
        self._last = None
        self._drain = _LiveDrainThread(source) if getattr(source, "is_live", False) else None

    def read(self):
        if self._drain is not None:
            f = self._drain.read()
            if f is not None:
                self._last = f
            elif self._drain.dead or self.source.exhausted:
                return None  # ended: do not repeat the last frame forever
            return self._last
        if self.source.exhausted:
            return None
        self._acc += self._ratio
        if self._last is None or self._acc >= 1.0:
            if self._acc >= 1.0:
                self._acc -= 1.0
            f = self.source.read()
            if f is not None:
                self._last = f
            elif self.source.exhausted:
                return None
        return self._last

    def release(self):
        if self._drain is not None and not self._drain.stop():
            # the drain thread is still inside a blocking read (a stalled
            # RTSP stream): releasing the capture under it is a use after
            # release; leak it instead (the daemon thread dies with the process)
            print("drain thread still in a blocking read; leaking capture")
            return
        self.source.release()


def resolve_cameras(cam_config_path: Optional[str], n_streams: Optional[int] = None):
    """(anomaly_settings, source specs, names, fps per camera): every entry of
    the cam_config's camera_list, or ``n_streams`` (default 2) synthetic
    cameras when there is no cam_config."""
    if cam_config_path:
        cam_config = load_cam_config(cam_config_path)
        cams = cam_config["camera_list"]
        return (cam_config.get("anomaly_settings"), [c.get("url") for c in cams],
                [c.get("name", f"cam{i}") for i, c in enumerate(cams)],
                [float(c.get("fps", 20)) for c in cams])
    n = n_streams or 2
    return None, ["synthetic"] * n, [f"synthetic{i}" for i in range(n)], [20.0] * n


def load_serving_model(model_dir: Optional[str], config_path: Optional[str], device,
                       quantize: bool = False, continual_learning: bool = False,
                       init_seed: int = 0, log: Callable = print):
    """(model, config, qparams) for a serving surface: from ``model_dir``
    through ``stream/engine.py::boot_serving_model`` (an int8 boot with
    ``quantize`` and without continual learning; a continual-learning resume
    restores Adam's moments with the weights), or, from ``config_path``,
    built with seeded random weights and ``qparams`` None."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path

    if model_dir is None:
        model, config = load_model_from_config_path(config_path, seed=init_seed, device=device)
        return model, config, None
    return boot_serving_model(model_dir, device, quantize=quantize,
                              int8_checkpoint_boot=not continual_learning,
                              restore_optimizer=continual_learning, log=log)


def run_all_cameras(engine: MultiCameraEngine, readers: Sequence, names: Sequence[str],
                    max_frames: Optional[int] = None, stats_jsonl: Optional[str] = None,
                    realtime: bool = False, fps: float = 20.0,
                    stop: Optional[StopRequest] = None, on_tick: Optional[Callable] = None,
                    log: Callable = print, clock: Optional[Callable[[int], float]] = None,
                    max_rss_mb: Optional[float] = None) -> dict:
    """Batched multi-stream scoring: every tick reads one frame (or None) from
    each of ``readers`` (objects with ``read()`` and ``release()``, e.g.
    ``PacedReader``) and scores them in one dispatch of ``engine``, until a tick
    on which no reader has a frame, ``max_frames`` ticks ran, ``stop`` is requested
    or the rss guard trips, then ends as ``run_stream`` does; ``clock(n)`` as
    there.
    Per-tick latency is host time around ``process_frames`` alone (reading the
    cameras is outside it, as in ``run_stream``), whose score fetch waits for
    the device (in pipelined mode, for the previous tick).
    ``on_tick(tick, results)`` sees every tick's results. Returns a summary:
    ticks, latencies (ms), p50/p95/mean over the latencies after the first
    two when there are more than four, the host's resident memory (MB)."""
    stats_file = open(stats_jsonl, "w") if stats_jsonl else None
    n = 0
    latencies: List[float] = []
    rss_tripped = False
    try:
        while max_frames is None or n < max_frames:
            if stop is not None and stop.count:
                raise KeyboardInterrupt
            if rss_guard_tripped(engine, n, max_rss_mb, log):
                rss_tripped = True
                break
            t_tick = time.perf_counter()
            frames = [r.read() for r in readers]
            if all(f is None for f in frames):
                break
            t0 = time.perf_counter()
            results = engine.process_frames(frames, now=None if clock is None else clock(n),
                                            tag=n)
            lat_ms = (time.perf_counter() - t0) * 1000.0
            latencies.append(lat_ms)
            # pipelined mode emits tick N-1's results at tick N: the engine
            # says which tick the returned scores belong to
            scored_tick = engine.last_emitted_tag
            if on_tick is not None:
                on_tick(scored_tick, results)
            if n % 20 == 0:
                line = " | ".join(
                    f"{names[i]}: AS={r.score: .3f}{' **' if r.anomalous else ''}"
                    for i, r in enumerate(results) if r is not None)
                log(f"tick {n} ({lat_ms:.1f} ms): {line}")
            if stats_file and scored_tick is not None:
                stats_file.write(json.dumps({
                    "tick": scored_tick, "latency_ms": round(lat_ms, 3),
                    "scores": [None if r is None else r.score for r in results],
                    "anomalous": [None if r is None else r.anomalous for r in results],
                }) + "\n")
            n += 1
            if realtime:
                time.sleep(max(0.0, 1.0 / fps - (time.perf_counter() - t_tick)))
    except KeyboardInterrupt:
        log("Keyboard Interrupt")
    finally:
        for r in readers:
            r.release()
        try:
            last = engine.flush() if engine.pipelined else None
            if last is not None:
                if on_tick is not None:
                    on_tick(engine.last_emitted_tag, last)
                if stats_file:
                    stats_file.write(json.dumps({
                        "tick": engine.last_emitted_tag, "flushed": True,
                        "scores": [None if r is None else r.score for r in last],
                    }) + "\n")
        except Exception as e:  # noqa: BLE001: the recording and the drain must still close
            log(f"flush failed: {e!r}")
        try:
            close_run(engine, log)
        finally:
            if stats_file:
                stats_file.close()
    summary = {"ticks": n, "streams": len(readers), "latencies_ms": latencies,
               "rss_mb": rss_mb(), "rss_tripped": rss_tripped}
    if latencies:
        lat = np.array(latencies[2:] if len(latencies) > 4 else latencies)
        summary.update(p50_ms=float(np.percentile(lat, 50)),
                       p95_ms=float(np.percentile(lat, 95)), mean_ms=float(lat.mean()))
        log(f"processed {n} ticks x {len(readers)} streams; tick latency "
            f"p50={summary['p50_ms']:.2f} ms p95={summary['p95_ms']:.2f} ms "
            f"mean={summary['mean_ms']:.2f} ms; host RSS {summary['rss_mb']:.0f} MB")
    else:
        log(f"processed {n} ticks x {len(readers)} streams")
    return summary


def make_paced_readers(specs: Sequence, fps_list: Sequence[float]) -> List[PacedReader]:
    """One ``PacedReader`` per source spec, paced against the fastest camera."""
    tick_fps = max(fps_list)
    return [PacedReader(make_source(s, fps=f), f, tick_fps) for s, f in zip(specs, fps_list)]
