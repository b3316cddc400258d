"""Multi-camera batched streaming inference and anomaly scoring.

Counterpart of the inference half of ``trustedai_cl_vae_ad_tpu/stream/
multicam.py::MultiCameraEngine``. One model serves K camera streams: a tick
uploads the K uint8 frames as one batch, normalizes and resizes them on the
device, runs ONE forward for all of them (float, or int8 through
``ops/quant.py``: the weights are read once per tick, whatever K is) and one
launch of the stream-scorer kernel over a grid of K frames
(``ops/stream_score.py::stream_score_step_batched``; the JAX engine runs a
vmapped jnp reference there), then fetches the K [score, count] pairs in one
copy and advances K host-side state machines. The scorer state is batched:
maps (K, 2, H, W), scalars (K, 6).

A camera that drops a tick is handled with a validity mask: that stream's
EMA state is left untouched, its result is None and its score would be NaN.

Ported: scoring, the per-stream state machines with fixed and per-stream CDF
thresholds, ``new_task`` / ``reset_stream``, mixed camera resolutions (host
resize onto the pinned batch shape), the provisional warm-up pin, pipelined
mode with ``flush``, int8 serving (``quantize=`` / ``qparams=``). Not ported
yet, each raising NotImplementedError that names its ROADMAP item: fleet
continual learning and its replay buffer, recording, autosave, and a device
mesh.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.anomaly.cdf import CDFObject, threshold_from_cdf
from trustedai_cl_vae_ad_tpu_torch.data.ingest import resize_images
from trustedai_cl_vae_ad_tpu_torch.ops import stream_score
from trustedai_cl_vae_ad_tpu_torch.ops.quant import serving_forward
from trustedai_cl_vae_ad_tpu_torch.stream.engine import _to_u8, validate_anomaly_settings
from trustedai_cl_vae_ad_tpu_torch.utils.profiling import defer_signals

_FLEET_CL_ITEM = ("fleet continual learning is not ported yet (ROADMAP.md queue 1 item 14: "
                  "the fleet ring, the shared replay buffer and the fleet CL step)")
_RECORD_ITEM = ("multi-camera recording is not ported yet (ROADMAP.md queue 1 item 14, "
                "after item 12's recording)")
_AUTOSAVE_ITEM = ("multi-camera autosave is not ported yet (ROADMAP.md queue 1 item 14, "
                  "after item 8's checkpoint layout)")
_MESH_ITEM = "device meshes are not ported yet (ROADMAP.md queue 1 item 17)"


@dataclass
class StreamStatus:
    score: float
    score_ma: float
    pixel_count: float
    anomalous: bool
    _norm_dev: object = None
    _rec_dev: object = None
    # memoized host copies: each fetch is a device->host round trip, and a
    # reader of the same map twice per tick must not pay for two
    _norm_np: object = None
    _rec_np: object = None

    @property
    def norm_err_u8(self) -> np.ndarray:
        if self._norm_np is None:
            self._norm_np = self._norm_dev.cpu().numpy()
        return self._norm_np

    @property
    def reconstruction_u8(self) -> np.ndarray:
        if self._rec_np is None:
            self._rec_np = self._rec_dev.cpu().numpy()
        return self._rec_np


class MultiCameraEngine:
    def __init__(
        self,
        model,
        config: dict,
        n_streams: int,
        anomaly_settings: Optional[dict] = None,
        stream_error_ma: float = 0.99,
        anomaly_ma_weight: float = 0.9,
        quantize: bool = False,
        model_cache_dir: Optional[str] = None,
        pipelined: bool = False,
        mesh=None,
        qparams: Optional[dict] = None,
    ):
        if n_streams < 1:
            raise ValueError(f"n_streams must be at least 1, got {n_streams}")
        if mesh is not None:
            raise NotImplementedError(_MESH_ITEM)
        if model_cache_dir is not None:
            raise NotImplementedError(_AUTOSAVE_ITEM)
        self.model = model
        self.device = model.device
        # ``qparams`` is a tree that is already quantized
        # (load_quantized_checkpoint): the int8-checkpoint boot, where
        # model.params may be None
        self.quantized = bool(quantize) or qparams is not None
        self.config = config
        self.n_streams = int(n_streams)
        if anomaly_settings is not None:
            validate_anomaly_settings(anomaly_settings)
        self.anomaly_settings = anomaly_settings
        self.stream_error_ma = float(stream_error_ma)
        self.anomaly_ma_weight = float(anomaly_ma_weight)

        size = config["data"]["image_size"]
        self.height, self.width, self.channels = int(size[0]), int(size[1]), int(size[2])
        k = self.n_streams
        self.maps = torch.zeros((k, 2, self.height, self.width), dtype=torch.float32,
                                device=self.device)
        self.scalars = torch.zeros((k, 6), dtype=torch.float32, device=self.device)

        self.score_ma = np.zeros(k, np.float64)
        self.anomalous = np.zeros(k, bool)
        self.anomalous_start: list = [None] * k

        # per-stream CDF thresholding (anomaly_score_method 'cdf'), as the
        # single-stream engine's per-task mechanism: each stream keeps its own
        # score history, so a task or camera change on one stream re-derives
        # only ITS threshold
        self._score_history = [deque(maxlen=1024) for _ in range(k)]
        self._cdf: list = [None] * k
        self._cdf_dirty = [0] * k
        self._task_scored = [0] * k  # per-stream cdf_warmup_skip counters

        self._ref_shape = None  # pinned at the first tick
        self._warm_pin = False  # _ref_shape came from warmup, not from a real tick
        self._resize_warned: set = set()

        # pipelined mode: dispatch tick N, return tick N-1's results, so the
        # device computes while the host fetches the next frames
        self.pipelined = bool(pipelined)
        self._pending = None
        self.last_emitted_tag = None

        self._forward, self._serve_params = serving_forward(
            model.core, model.params, quantize=self.quantized, qparams=qparams)

    # ----------------------------------------------------- unported controls
    @property
    def enable_cont_learning(self) -> bool:
        return False

    @enable_cont_learning.setter
    def enable_cont_learning(self, value: bool) -> None:
        if value:
            raise NotImplementedError(_FLEET_CL_ITEM)

    def set_learning_rate(self, lr: float) -> None:
        raise NotImplementedError(_FLEET_CL_ITEM)

    def load_replay_buffer_from_file(self, input_filename: str) -> int:
        raise NotImplementedError(_FLEET_CL_ITEM)

    def begin_recording(self, record_dir: str, names: Optional[List[str]] = None) -> str:
        raise NotImplementedError(_RECORD_ITEM)

    def save_model_to_dir(self, model_dir: str) -> str:
        raise NotImplementedError(_AUTOSAVE_ITEM)

    # ------------------------------------------------------------- the tick
    def _host_resize(self, i: int, frame: np.ndarray, ref_shape) -> np.ndarray:
        """Bring a stream whose camera delivers another resolution onto the
        pinned batch shape (bilinear on the host; warns once per stream)."""
        from PIL import Image

        if i not in self._resize_warned:
            self._resize_warned.add(i)
            print(f"multicam: stream {i} delivers {frame.shape}, resizing to "
                  f"the pinned batch shape {ref_shape}")
        if frame.ndim == 3 and frame.shape[-1] == 1:
            frame = frame[..., 0]  # PIL rejects (H, W, 1) arrays
        img = Image.fromarray(frame).resize((ref_shape[1], ref_shape[0]), Image.BILINEAR)
        out = np.asarray(img, np.uint8)
        if out.shape != tuple(ref_shape):  # channel mismatch
            if out.ndim == 2:  # gray -> replicate across the reference channels
                out = np.broadcast_to(out[..., None], ref_shape).copy()
            elif ref_shape[-1] == 1:  # RGB -> single channel: luminance
                lum = 0.299 * out[..., 0] + 0.587 * out[..., 1] + 0.114 * out[..., 2]
                out = np.clip(np.round(lum), 0, 255).astype(np.uint8)[..., None]
            else:
                out = np.broadcast_to(out[..., :1], ref_shape).copy()
        return out

    def _step(self, batch_u8: np.ndarray, valid: np.ndarray):
        """One tick on the device: normalize, resize, one forward for all K
        frames, one launch of the scorer over them. Returns the new state and
        the tick's device results; nothing is fetched."""
        x = torch.from_numpy(batch_u8).to(self.device).to(torch.float32) / 255.0
        x = resize_images(x, (self.height, self.width))
        x_hat = self._forward(self._serve_params, x)
        maps, scalars, norm, score_count = stream_score.stream_score_step_batched(
            self.maps, self.scalars, x, x_hat, self.stream_error_ma,
            torch.from_numpy(valid).to(self.device))
        return maps, scalars, _to_u8(norm), _to_u8(x_hat), score_count

    def warmup(self, frame_shape=None, cl: bool = False) -> None:
        """Build the kernels and run the tick once on zero frames BEFORE the
        cameras attach, so the first real tick pays neither the nvcc builds
        nor the first-call costs. The scorer state is untouched.

        Pins the batch shape to ``frame_shape`` (default: the model's
        resolution), provisionally: if the first real tick delivers another
        resolution, the pin moves to the delivered shape (the device resize
        then runs, as without a warm-up) and a line says so. A wrong
        ``frame_shape`` wastes the warm-up but never changes the scores."""
        if cl:
            raise NotImplementedError(_FLEET_CL_ITEM)
        shape = tuple(frame_shape) if frame_shape is not None else (
            self.height, self.width, self.channels)
        if self._ref_shape is None:
            self._ref_shape = shape
            self._warm_pin = True  # provisional until the first real tick
        with torch.inference_mode():
            *_state, score_count = self._step(
                np.zeros((self.n_streams, *self._ref_shape), np.uint8),
                np.ones(self.n_streams, bool))
            score_count.cpu()

    def process_frames(self, frames: Sequence[Optional[np.ndarray]],
                       now: Optional[float] = None,
                       tag: object = None) -> List[Optional[StreamStatus]]:
        """Score one tick of frames (len == n_streams; None = a dropped tick).

        ``tag``: the caller's id of this tick; after the call
        ``last_emitted_tag`` holds the tag of the tick the RETURNED results
        belong to (one tick behind in pipelined mode)."""
        if len(frames) != self.n_streams:
            raise ValueError(f"{len(frames)} frames for {self.n_streams} streams")
        now = time.monotonic() if now is None else now
        valid = np.array([f is not None for f in frames], bool)
        # dropped streams get a zero placeholder; the mask freezes their state.
        # The batch shape is pinned at the first tick; streams that deliver
        # another resolution are resized on the host.
        shapes = [f.shape for f in frames if f is not None]
        if self._ref_shape is None:
            self._ref_shape = tuple(shapes[0]) if shapes else (
                self.height, self.width, self.channels)
        elif self._warm_pin and shapes:
            # the warm-up's pin is provisional: the first real tick WITH
            # frames wins. An all-dropped tick (cameras still connecting)
            # does not confirm it.
            if tuple(shapes[0]) != self._ref_shape:
                print(f"warmup shape {self._ref_shape} != delivered frame {shapes[0]}: "
                      "re-pinning (pass --warmup HxW matching the cameras)")
                self._ref_shape = tuple(shapes[0])
            self._warm_pin = False
        ref_shape = self._ref_shape
        batch = np.zeros((self.n_streams, *ref_shape), np.uint8)
        for i, f in enumerate(frames):
            if f is not None:
                if f.shape != ref_shape:
                    f = self._host_resize(i, f, ref_shape)
                batch[i] = f

        # maps and scalars are re-assigned together: defer signals so an
        # interrupt never splits the two
        with defer_signals(), torch.inference_mode():
            self.maps, self.scalars, norm_u8, rec_u8, score_count = self._step(batch, valid)

        if self.pipelined:
            # return tick N-1's results while tick N computes on the device;
            # the validity mask and the tag travel with their results
            pending, self._pending = self._pending, (score_count, norm_u8, rec_u8, valid, tag)
            if pending is None:
                return [None] * self.n_streams  # the first tick's results come next call
            score_count, norm_u8, rec_u8, valid, tag = pending
        return self._emit(score_count, norm_u8, rec_u8, valid, now, tag)

    def flush(self, now: Optional[float] = None) -> Optional[List[Optional[StreamStatus]]]:
        """Pipelined mode: fetch the last in-flight tick's results."""
        if not self.pipelined or self._pending is None:
            return None
        now = time.monotonic() if now is None else now
        score_count, norm_u8, rec_u8, valid, tag = self._pending
        self._pending = None
        return self._emit(score_count, norm_u8, rec_u8, valid, now, tag)

    def _emit(self, score_count, norm_u8, rec_u8, valid, now,
              tag=None) -> List[Optional[StreamStatus]]:
        """Host side of one tick: the one score fetch, the moving averages and
        the per-stream state machines."""
        self.last_emitted_tag = tag
        sc = score_count.cpu().numpy()  # (K, 2), one device->host copy
        out: List[Optional[StreamStatus]] = []
        for i in range(self.n_streams):
            if not valid[i]:
                out.append(None)
                continue
            score = float(sc[i, 0])
            ma = self.anomaly_ma_weight * self.score_ma[i] + (1 - self.anomaly_ma_weight) * score
            if not np.isnan(ma):
                self.score_ma[i] = ma
            self._record_score(i, score)
            self._update_state_machine(i, score, now)
            out.append(StreamStatus(
                score=score,
                score_ma=float(self.score_ma[i]),
                pixel_count=float(sc[i, 1]),
                anomalous=bool(self.anomalous[i]),
                _norm_dev=norm_u8[i],
                _rec_dev=rec_u8[i],
            ))
        return out

    # ------------------------------------------------------- state machines
    def _record_score(self, i: int, score_f: float) -> None:
        """Append a finite score to stream i's CDF history, after the optional
        ``cdf_warmup_skip`` first scores of the stream's task."""
        self._task_scored[i] += 1
        if not np.isfinite(score_f):
            return
        skip = 0
        if self.anomaly_settings is not None:
            skip = int(self.anomaly_settings.get("cdf_warmup_skip", 0))
        if self._task_scored[i] <= skip:
            return
        self._score_history[i].append(score_f)
        self._cdf_dirty[i] += 1

    def current_threshold(self, i: int) -> Optional[float]:
        """Active threshold of stream i: fixed, or its own CDF quantile once
        32 scores exist; the options and defaults are the single-stream
        engine's (``StreamingEngine.current_threshold``). None without
        anomaly_settings (scoring runs, no state machine is configured)."""
        if self.anomaly_settings is None:
            return None
        threshold = float(self.anomaly_settings.get("anomaly_score_threshold"))
        method = str(self.anomaly_settings.get("anomaly_score_method", "fixed"))
        if method.startswith("cdf"):
            if len(self._score_history[i]) < 32:
                if bool(self.anomaly_settings.get("cdf_warmup_abstain", True)):
                    return float("inf")
                return threshold
            if self._cdf[i] is None or self._cdf_dirty[i] >= 16:
                window = int(self.anomaly_settings.get("cdf_window", 96))
                hist = np.asarray(self._score_history[i])
                self._cdf[i] = CDFObject(hist[-window:] if window > 0 else hist)
                self._cdf_dirty[i] = 0
            q = float(self.anomaly_settings.get("cdf_quantile", 0.995))
            robust = bool(self.anomaly_settings.get("cdf_robust_tail", True))
            adaptive = threshold_from_cdf(self._cdf[i], q, robust=robust)
            floor = float(self.anomaly_settings.get("cdf_floor", threshold))
            return max(adaptive, floor)
        return threshold

    def _update_state_machine(self, i: int, score: float, now: float) -> None:
        """Per-stream threshold and hold period."""
        if self.anomaly_settings is None:
            self.anomalous[i] = False
            return
        threshold = self.current_threshold(i)
        if score > threshold:
            if not self.anomalous[i]:
                self.anomalous_start[i] = now
            self.anomalous[i] = True
        elif self.anomalous[i] and self.anomalous_start[i] is not None:
            hold = float(self.anomaly_settings.get("anomalous_state_period_s"))
            if now - self.anomalous_start[i] > hold:
                self.anomalous[i] = False

    def reset_stream(self, i: int) -> None:
        """Task or camera change on one stream: reset its EMA state only."""
        with torch.inference_mode():  # the state tensors were made under it
            self.maps[i] = 0.0
            self.scalars[i] = 0.0
        self.score_ma[i] = 0.0
        self.anomalous[i] = False
        self.anomalous_start[i] = None

    def new_task(self, i: Optional[int] = None, reset_scorer: bool = False) -> None:
        """Task boundary for stream i (or ALL streams when None): reset the
        stream's score CDF so that its threshold re-derives. The scorer's EMA
        state is kept by default (re-seeding it rails the score at the z-cap
        for dozens of frames); ``reset_scorer=True`` is the hard reset for a
        physical camera swap. The anomalous state is not cleared: a stream in
        mid-alarm keeps its hold period and expires on its own."""
        streams = range(self.n_streams) if i is None else [i]
        for s in streams:
            self._score_history[s].clear()
            self._cdf[s] = None
            self._cdf_dirty[s] = 0
            self._task_scored[s] = 0
            if reset_scorer:
                self.reset_stream(s)
            else:
                self.score_ma[s] = 0.0
