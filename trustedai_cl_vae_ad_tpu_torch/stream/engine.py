"""Headless single-stream inference engine.

Counterpart of the inference path of ``trustedai_cl_vae_ad_tpu/stream/
engine.py::StreamingEngine``:

  * a device ring of 16 frames; the first frame seeds every slot;
  * per frame: upload the uint8 frame, normalize it, resize it on the device
    when it is not at model size, run the CVAE's eval forward and the fused
    EMA scorer (ops/stream_score.py, a CUDA kernel on the card), then fetch
    [score, count] to the host in one copy;
  * ``pipelined`` mode returns the previous frame's result (one-frame lag,
    with the frame's tag);
  * the inference hold-off, the anomaly state machine with its hold period,
    fixed and per-task CDF thresholds, ``new_task``;
  * the per-phase ``timings`` dict.

Continual learning, recording, replay buffers, int8 serving and autosave
are not ported yet: asking for them raises NotImplementedError naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.anomaly.cdf import CDFObject, threshold_from_cdf
from trustedai_cl_vae_ad_tpu_torch.config import load_config
from trustedai_cl_vae_ad_tpu_torch.data.ingest import resize_images
from trustedai_cl_vae_ad_tpu_torch.ops import stream_score
from trustedai_cl_vae_ad_tpu_torch.ops.quant import serving_forward
from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState
from trustedai_cl_vae_ad_tpu_torch.utils.profiling import defer_signals

_CL_ITEM = "continual learning is not ported yet (ROADMAP.md queue 1 items 3-7)"
_RECORD_ITEM = "recording is not ported yet (ROADMAP.md queue 1 item 12)"
_REPLAY_ITEM = "replay buffers are not ported yet (ROADMAP.md queue 1 item 12)"
_AUTOSAVE_ITEM = "model autosave is not ported yet (ROADMAP.md queue 1 item 8)"


def validate_anomaly_settings(anomaly_settings: dict) -> dict:
    """cam_config['anomaly_settings'] schema."""
    if anomaly_settings is None:
        raise ValueError("anomaly_settings is None")
    for key in (
        "anomaly_score_threshold",
        "anomaly_score_method",
        "buffer_record_period_s",
        "anomalous_state_period_s",
    ):
        if key not in anomaly_settings:
            raise ValueError(f"anomaly_settings missing {key}")
    return anomaly_settings


def load_cam_config(path: str, index: int = 0) -> dict:
    """cam_config.yml: camera_list + anomaly_settings."""
    cam_config = load_config(path)
    cams = cam_config.get("camera_list")
    if not cams:
        raise ValueError(f"{path}: camera_list is missing or empty")
    if index >= len(cams):
        raise ValueError(f"{path}: camera index {index} out of range ({len(cams)} cameras)")
    if "anomaly_settings" in cam_config:
        validate_anomaly_settings(cam_config["anomaly_settings"])
    return cam_config


@dataclass
class FrameResult:
    score: float
    score_ma: float
    pixel_count: float
    anomalous: bool
    _norm_dev: object = None       # device tensors; fetched lazily
    _rec_dev: object = None
    cl_stepped: bool = False
    tag: object = None             # caller's id of the SCORED frame (pipelined
    # results lag one submitted frame, and hold-off skips drop submissions)
    _norm_np: object = None        # memoized host copies (one fetch each)
    _rec_np: object = None

    @property
    def norm_err_u8(self) -> np.ndarray:
        """(H, W) uint8 normalized error map (device->host on first access)."""
        if self._norm_np is None:
            self._norm_np = self._norm_dev.cpu().numpy()
        return self._norm_np

    @property
    def reconstruction_u8(self) -> np.ndarray:
        """(H, W, C) uint8 reconstruction (device->host on first access)."""
        if self._rec_np is None:
            self._rec_np = self._rec_dev.cpu().numpy()
        return self._rec_np


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(255.0 * x), 0, 255).to(torch.uint8)


class StreamingEngine:
    RING_SIZE = 16

    def __init__(
        self,
        model,
        config: dict,
        anomaly_settings: Optional[dict] = None,
        stream_error_ma: float = 0.99,
        anomaly_ma_weight: float = 0.9,
        inference_period_ms: float = 50.0,
        host_resize: bool = False,
        pipelined: bool = False,
        quantize: bool = False,
        model_cache_dir: Optional[str] = None,
    ):
        if model_cache_dir is not None:
            raise NotImplementedError(_AUTOSAVE_ITEM)
        self.model = model
        self.device = model.device
        self.anomaly_settings = (
            validate_anomaly_settings(anomaly_settings)
            if anomaly_settings is not None
            else None
        )
        self.stream_error_ma = float(stream_error_ma)
        self.anomaly_ma_weight = float(anomaly_ma_weight)
        self.inference_period_ms = inference_period_ms
        # shrink frames on the host (cv2 INTER_AREA) before upload: a smaller
        # host->device copy in place of the device's antialiased resize
        self.host_resize = host_resize
        # pipelined: dispatch frame N, return frame N-1's result, so the
        # device->host fetch of N-1 overlaps frame N's work. Results lag one
        # frame and carry their frame's tag.
        self.pipelined = pipelined
        self._pending = None

        size = config["data"]["image_size"]
        self.height, self.width, self.channels = int(size[0]), int(size[1]), int(size[2])

        # device-resident state
        self.ring = torch.zeros((self.RING_SIZE, self.height, self.width, self.channels),
                                dtype=torch.float32, device=self.device)
        self.ring_idx = 0
        self.ring_filled = 0
        self.score_state: StreamScoreState = stream_score.init_state(
            self.height, self.width, self.device)

        # per-task CDF thresholding over the recent score history
        self._score_history: deque = deque(maxlen=1024)
        self._cdf = None
        self._cdf_dirty = 0
        self._task_scored = 0  # frames scored since the last new_task()

        self.enable_anomaly_state = True
        self.anomaly_score = 0.0
        self.anomaly_score_ma = 0.0
        self.anomalous_state = False
        self.anomalous_start_time: Optional[float] = None
        self._last_inference_t = 0.0

        self.process_rate = 0.0
        self.timings: dict = {}

        self._forward, self._serve_params = serving_forward(
            model.core, model.params, quantize=quantize)

    # ----------------------------------------------------- unported controls
    @property
    def enable_cont_learning(self) -> bool:
        return False

    @enable_cont_learning.setter
    def enable_cont_learning(self, value: bool) -> None:
        if value:
            raise NotImplementedError(_CL_ITEM)

    def set_learning_rate(self, lr: float) -> None:
        raise NotImplementedError(_CL_ITEM)

    def begin_recording(self, record_dir: str) -> str:
        raise NotImplementedError(_RECORD_ITEM)

    def load_replay_buffer_from_file(self, input_filename: str) -> int:
        raise NotImplementedError(_REPLAY_ITEM)

    def load_replay_buffer_from_filelist(self, filelist: list) -> int:
        raise NotImplementedError(_REPLAY_ITEM)

    # -------------------------------------------------------- the dispatch
    def _infer_score(self, ring, idx, frame_u8, state, seed_ring):
        """Normalize, resize, update the ring (in place), forward, score."""
        x = torch.from_numpy(frame_u8).to(self.device).to(torch.float32) / 255.0
        b = resize_images(x[None], (self.height, self.width))
        img = b[0]
        if seed_ring:
            # the first frame seeds EVERY ring slot, so early continual-
            # learning steps never train on all-zero frames
            ring.copy_(b.expand_as(ring))
        else:
            ring[idx] = img
        x_hat = self._forward(self._serve_params, b)[0]
        state, norm, score, count = stream_score.stream_score_step(
            state, img, x_hat, self.stream_error_ma)
        score_count = torch.stack([score, count])  # one packed scalar fetch
        return state, _to_u8(norm), _to_u8(x_hat), score_count

    def warmup(self, frame_shape=None, cl: bool = False) -> None:
        """Build the scorer kernel and run the dispatch once on scratch state
        BEFORE the first camera frame, so frame 0 pays neither the nvcc build
        nor the first-call costs (cuDNN algorithm choice, allocator growth).
        The engine's ring and scorer state are untouched.

        ``frame_shape``: (H, W, C) the camera delivers (default: model size).
        """
        if cl:
            raise NotImplementedError(_CL_ITEM)
        shape = tuple(frame_shape) if frame_shape is not None else (
            self.height, self.width, self.channels)
        if self.device.type == "cuda":
            stream_score.build()
        ring = torch.zeros_like(self.ring)
        state = stream_score.init_state(self.height, self.width, self.device)
        with torch.inference_mode():
            _, _, _, score_count = self._infer_score(
                ring, 0, np.zeros(shape, np.uint8), state, True)
            score_count.cpu()

    # -------------------------------------------------------------- main path
    def process_frame(self, frame_u8: np.ndarray, now: Optional[float] = None,
                      tag: object = None) -> Optional[FrameResult]:
        """Run inference + scoring for one RGB uint8 frame.

        Returns None inside the inference hold-off period, and for the first
        frame in pipelined mode (its result comes with the next call)."""
        t_start = time.perf_counter()
        now = time.monotonic() if now is None else now
        if (now - self._last_inference_t) * 1000.0 < self.inference_period_ms:
            return None
        self._last_inference_t = now

        frame_u8 = np.ascontiguousarray(frame_u8)
        if self.host_resize and frame_u8.shape[:2] != (self.height, self.width):
            try:
                import cv2
            except ImportError:
                cv2 = None  # no OpenCV: the device resize runs instead
            if cv2 is not None:
                # cv2.resize takes (width, height); tensor axes are (H, W)
                frame_u8 = cv2.resize(
                    frame_u8, (self.width, self.height), interpolation=cv2.INTER_AREA)
        idx = self.ring_idx = (self.ring_idx + 1) % self.RING_SIZE
        self.ring_filled = min(self.ring_filled + 1, self.RING_SIZE)

        # the ring updates in place before the scorer state is re-assigned:
        # defer signals so an interrupt never splits the two
        with defer_signals(), torch.inference_mode():
            self.score_state, norm_u8, rec_u8, score_count = self._infer_score(
                self.ring, idx, frame_u8, self.score_state, self.ring_filled == 1)
        if self.pipelined:
            pending, self._pending = self._pending, (score_count, norm_u8, rec_u8, tag)
            if pending is None:
                return None  # the first frame's result arrives next call
            score_count, norm_u8, rec_u8, tag = pending
        score, count = score_count.cpu().numpy()  # single small device->host fetch
        t_infer = time.perf_counter()

        result = self._finish(float(score), float(count), norm_u8, rec_u8, tag, now)

        t_end = time.perf_counter()
        self.timings = {
            "infer_s": t_infer - t_start,
            "cl_s": 0.0,
            "record_s": t_end - t_infer,
            "total_s": t_end - t_start,
        }
        self.process_rate = 0.9 * self.timings["total_s"] + 0.1 * self.process_rate
        return result

    def flush(self, now: Optional[float] = None) -> Optional[FrameResult]:
        """Pipelined mode: fetch the last in-flight frame's result."""
        if not self.pipelined or self._pending is None:
            return None
        now = time.monotonic() if now is None else now
        score_count, norm_u8, rec_u8, tag = self._pending
        self._pending = None
        score, count = score_count.cpu().numpy()
        return self._finish(float(score), float(count), norm_u8, rec_u8, tag, now)

    def _finish(self, score_f, count_f, norm_u8, rec_u8, tag, now) -> FrameResult:
        self.anomaly_score = score_f
        self._record_score(score_f)
        self.check_anomalous_state(now)
        ma = self.anomaly_ma_weight * self.anomaly_score_ma + (1.0 - self.anomaly_ma_weight) * score_f
        if not np.isnan(ma):  # NaN scores leave the moving average alone
            self.anomaly_score_ma = ma
        return FrameResult(
            score=score_f,
            score_ma=self.anomaly_score_ma,
            pixel_count=count_f,
            anomalous=self.anomalous_state,
            _norm_dev=norm_u8,
            _rec_dev=rec_u8,
            tag=tag,
        )

    # ------------------------------------------------------- state machine
    def toggle_anomalous_state(self, state: bool, now: Optional[float] = None) -> None:
        if self.enable_anomaly_state:
            if state and not self.anomalous_state:
                self.anomalous_start_time = time.monotonic() if now is None else now
            self.anomalous_state = state
        else:
            self.anomalous_state = False

    def new_task(self, reset_scorer: bool = False) -> None:
        """Task boundary: reset the per-task score CDF. The scorer's EMA state
        is kept by default (it re-adapts on its own; re-seeding it rails the
        score at the z-cap for dozens of frames); ``reset_scorer=True``
        re-seeds it, e.g. after a camera swap."""
        self._score_history.clear()
        self._cdf = None
        self._cdf_dirty = 0
        self._task_scored = 0
        if reset_scorer:
            self.score_state = stream_score.init_state(self.height, self.width, self.device)
        self.anomaly_score_ma = 0.0

    def _record_score(self, score_f: float) -> None:
        """Append a finite score to the per-task CDF history, after the
        optional ``cdf_warmup_skip`` first scores of the task."""
        self._task_scored += 1
        if not np.isfinite(score_f):
            return
        skip = 0
        if self.anomaly_settings is not None:
            skip = int(self.anomaly_settings.get("cdf_warmup_skip", 0))
        if self._task_scored <= skip:
            return
        self._score_history.append(score_f)
        self._cdf_dirty += 1

    def current_threshold(self) -> Optional[float]:
        """Active anomaly threshold: fixed, or the per-task CDF quantile
        (``anomaly_score_method`` starting with 'cdf'). None without
        anomaly_settings. The CDF options and their defaults are those of the
        JAX engine: ``cdf_floor`` (the fixed threshold), ``cdf_warmup_abstain``
        (True: +inf until 32 scores), ``cdf_window`` (96), ``cdf_quantile``
        (0.995), ``cdf_robust_tail`` (True)."""
        if self.anomaly_settings is None:
            return None
        threshold = float(self.anomaly_settings.get("anomaly_score_threshold"))
        method = str(self.anomaly_settings.get("anomaly_score_method", "fixed"))
        if method.startswith("cdf"):
            if len(self._score_history) < 32:
                if bool(self.anomaly_settings.get("cdf_warmup_abstain", True)):
                    return float("inf")
                return threshold
            if self._cdf is None or self._cdf_dirty >= 16:
                window = int(self.anomaly_settings.get("cdf_window", 96))
                hist = np.asarray(self._score_history)
                self._cdf = CDFObject(hist[-window:] if window > 0 else hist)
                self._cdf_dirty = 0
            q = float(self.anomaly_settings.get("cdf_quantile", 0.995))
            robust = bool(self.anomaly_settings.get("cdf_robust_tail", True))
            adaptive = threshold_from_cdf(self._cdf, q, robust=robust)
            floor = float(self.anomaly_settings.get("cdf_floor", threshold))
            return max(adaptive, floor)
        return threshold

    def check_anomalous_state(self, now: Optional[float] = None) -> None:
        """Threshold + hold-period state machine on the (injectable) clock."""
        now = time.monotonic() if now is None else now
        if self.anomaly_settings is not None:
            threshold = self.current_threshold()
            if self.anomaly_score > threshold:
                self.toggle_anomalous_state(True, now)
            elif self.anomalous_state and self.anomalous_start_time is not None:
                hold_s = float(self.anomaly_settings.get("anomalous_state_period_s"))
                if now - self.anomalous_start_time > hold_s:
                    self.toggle_anomalous_state(False, now)
        else:
            self.toggle_anomalous_state(False, now)
