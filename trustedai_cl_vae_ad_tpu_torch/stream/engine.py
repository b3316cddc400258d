"""Headless single-stream inference and continual-learning engine.

Counterpart of ``trustedai_cl_vae_ad_tpu/stream/engine.py::StreamingEngine``
without its recording and autosave:

  * a device ring of 16 frames; the first frame seeds every slot;
  * per frame: upload the uint8 frame, normalize it, resize it on the device
    when it is not at model size, run the CVAE's eval forward and the fused
    EMA scorer (ops/stream_score.py, a CUDA kernel on the card), then fetch
    [score, count] to the host in one copy;
  * ``pipelined`` mode returns the previous frame's result (one-frame lag,
    with the frame's tag);
  * the inference hold-off, the anomaly state machine with its hold period,
    fixed and per-task CDF thresholds, ``new_task``;
  * continual learning: at its own cadence a gradient step on the ring
    [+ the replay buffer] with the loss of the model's type and Adam in
    place, so the next frame is scored with the updated weights (the serving
    forward reads the same tensors). The learning rate is re-dialed at run
    time; the img-noise dial is stored but, as in the JAX engine, has no
    effect on the training loss (the input-fuzz path is dead). The optimizer
    and its moments are allocated at the first use of a CL control, never
    for an inference-only stream;
  * the replay buffer, loaded from a txt or csv of image paths and held on
    the device padded to a fixed capacity; padded rows carry weight 0 and
    drop out of every loss statistic;
  * int8 serving (``quantize=True``): the inference dispatch runs on a
    quantized copy of the large Dense kernels (ops/quant.py); continual
    learning keeps the float parameters and the serving copy is quantized
    again after each step. ``qparams=`` serves a tree that is already
    quantized (an int8-checkpoint boot, where the model holds no float
    parameters and continual learning raises);
  * the per-phase ``timings`` dict.

Recording and autosave are not ported yet: asking for them raises
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import csv
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.anomaly.cdf import CDFObject, threshold_from_cdf
from trustedai_cl_vae_ad_tpu_torch.config import load_config
from trustedai_cl_vae_ad_tpu_torch.data.ingest import preprocess_batch, resize_images
from trustedai_cl_vae_ad_tpu_torch.data.pipeline import ParallelDecodeIterable
from trustedai_cl_vae_ad_tpu_torch.ops import moments, stream_score
from trustedai_cl_vae_ad_tpu_torch.ops.quant import serving_forward
from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState
from trustedai_cl_vae_ad_tpu_torch.utils.profiling import defer_signals

_RECORD_ITEM = "recording is not ported yet (ROADMAP.md queue 1 item 12)"
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
    loss: Optional[dict] = None    # the CL step's loss dict, when one ran
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
        cam_info: Optional[dict] = None,
        stream_error_ma: float = 0.99,
        anomaly_ma_weight: float = 0.9,
        inference_period_ms: float = 50.0,
        continuous_learning_period_ms: float = 500.0,
        host_resize: bool = False,
        pipelined: bool = False,
        metrics=None,
        replay_capacity: int = 256,
        quantize: bool = False,
        model_cache_dir: Optional[str] = None,
        qparams: Optional[dict] = None,
    ):
        if model_cache_dir is not None:
            raise NotImplementedError(_AUTOSAVE_ITEM)
        self.model = model
        # int8 Dense kernels for the inference dispatch (ops/quant.py): the
        # frame's forward streams its weights, so fewer weight bytes are less
        # device time. ``qparams`` is a tree that is already quantized
        # (load_quantized_checkpoint): model.params may then be None.
        self.quantized = bool(quantize) or qparams is not None
        self.device = model.device
        self.cam_info = cam_info or {}
        self.anomaly_settings = (
            validate_anomaly_settings(anomaly_settings)
            if anomaly_settings is not None
            else None
        )
        self.stream_error_ma = float(stream_error_ma)
        self.anomaly_ma_weight = float(anomaly_ma_weight)
        self.inference_period_ms = inference_period_ms
        self.continuous_learning_period_ms = continuous_learning_period_ms
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
        # The replay buffer is held PADDED to a fixed capacity with a row
        # weight vector: weight-0 rows drop out of every loss statistic, so
        # the CL batch has one shape however many images a replay file holds
        # (one cuDNN algorithm choice, one allocator footprint).
        self.replay_capacity = int(replay_capacity)
        self.replay_buffer: Optional[torch.Tensor] = None
        self.replay_n = 0
        self.replay_buffer_paths: Optional[list] = None

        # each CL epoch's loss dict, with anomaly_score and anomaly_score_ma,
        # goes to this writer (utils/metrics.py::MetricsWriter) under "cl/"
        self.metrics = metrics

        # per-task CDF thresholding over the recent score history
        self._score_history: deque = deque(maxlen=1024)
        self._cdf = None
        self._cdf_dirty = 0
        self._task_scored = 0  # frames scored since the last new_task()

        # mutable dials
        self.enable_cont_learning = False
        self.enable_anomaly_state = True
        self.anomaly_score = 0.0
        self.anomaly_score_ma = 0.0
        self.anomalous_state = False
        self.anomalous_start_time: Optional[float] = None
        self.cl_epochs = 0
        self.last_epoch_loss: Optional[dict] = None
        self.model_changed_flag = False
        self._last_inference_t = 0.0
        self._last_cl_t = 0.0

        self.process_rate = 0.0
        self.timings: dict = {}

        self._forward, self._serve_params = serving_forward(
            model.core, model.params, quantize=self.quantized, qparams=qparams)

    # ----------------------------------------------------- unported controls
    def begin_recording(self, record_dir: str) -> str:
        raise NotImplementedError(_RECORD_ITEM)

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
        ``cl``: also prepare the continual-learning step: allocate the
        optimizer and its moments, build the moments kernels, and run the
        loss and its backward once on a scratch batch of the CL step's shape
        (load the replay buffer first, as the CLI does). The gradients are
        dropped: parameters, moments, the model's generator and the ring
        stay as they were.
        """
        shape = tuple(frame_shape) if frame_shape is not None else (
            self.height, self.width, self.channels)
        if self.device.type == "cuda":
            stream_score.build_for(1, self.height * self.width, self.channels)
        ring = torch.zeros_like(self.ring)
        state = stream_score.init_state(self.height, self.width, self.device)
        with torch.inference_mode():
            _, _, _, score_count = self._infer_score(
                ring, 0, np.zeros(shape, np.uint8), state, True)
            score_count.cpu()
        if cl:
            self._ensure_cl()
            if self.device.type == "cuda":
                moments.build()
            n = self.RING_SIZE + (0 if self.replay_buffer is None else self.replay_buffer.shape[0])
            # mid-grey, not zeros: an all-zero latent has no z_l2 gradient
            stacked = torch.full((n, self.height, self.width, self.channels), 0.5,
                                 dtype=self.ring.dtype, device=self.device)
            eps = torch.zeros((n, self.model.latent_size), device=self.device)
            loss = self.model.core.compute_loss(
                stacked, training=True, eps=eps,
                weights=torch.ones(n, device=self.device))["loss"]
            grads = torch.autograd.grad(loss, self.model.optimizer.params)
            float(grads[0].flatten()[0])  # wait for the backward

    def _ensure_cl(self) -> None:
        """Attach the optimizer (allocating Adam's moments on the device) at
        the first use of a CL control: an inference-only stream never holds
        them (the flagship's are twice its parameter bytes). Raises on an
        int8-checkpoint boot: there are no float parameters to train."""
        if self.model.params is None:
            raise RuntimeError(
                "continual learning needs float params, but this engine was booted from an "
                "int8 checkpoint (inference-only). Load the float checkpoint to train.")
        if self.model.optimizer is None:
            self.model.compile()

    # -------------------------------------------------------------- main path
    def process_frame(self, frame_u8: np.ndarray, now: Optional[float] = None,
                      tag: object = None) -> Optional[FrameResult]:
        """Run inference + scoring (+ continual learning at its cadence)
        for one RGB uint8 frame.

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

        # continual learning at its cadence, before this frame's score is
        # booked (the CL record carries the previous frame's score)
        cl_stepped = False
        loss = None
        if (
            self.enable_cont_learning
            and (now - self._last_cl_t) * 1000.0 > self.continuous_learning_period_ms
        ):
            self._last_cl_t = now
            loss = self._do_cl_step()
            cl_stepped = True
        t_cl = time.perf_counter()

        result = self._finish(float(score), float(count), norm_u8, rec_u8, tag, now,
                              cl_stepped=cl_stepped, loss=loss)

        t_end = time.perf_counter()
        self.timings = {
            "infer_s": t_infer - t_start,
            "cl_s": t_cl - t_infer,
            "record_s": t_end - t_cl,
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

    def _finish(self, score_f, count_f, norm_u8, rec_u8, tag, now, cl_stepped=False,
                loss=None) -> FrameResult:
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
            cl_stepped=cl_stepped,
            loss=loss,
            tag=tag,
        )

    # ---------------------------------------------------- continual learning
    def _cl_batch(self):
        """(stacked frames, row weights) of one CL step: the ring, then the
        capacity-padded replay buffer, whose padding rows weigh 0."""
        if self.replay_buffer is None:
            return self.ring, torch.ones(self.RING_SIZE, device=self.device)
        stacked = torch.cat([self.ring, self.replay_buffer], dim=0)
        weights = torch.zeros(stacked.shape[0], device=self.device)
        weights[: self.RING_SIZE + self.replay_n] = 1.0
        return stacked, weights

    def _do_cl_step(self) -> dict:
        """One gradient step on ring [+ replay]; returns the loss dict as
        floats, with the engine's anomaly scores added."""
        self._ensure_cl()
        stacked, weights = self._cl_batch()
        # parameters and moments update in place, tensor by tensor: defer
        # signals so an interrupt never leaves a step half applied
        with defer_signals():
            loss, _x_hat = self.model.train_step_and_run(stacked, weights=weights)
            if self.quantized:
                # the float layers of the serving tree are the model's own
                # tensors; the int8 copies follow the trained weights here
                _, self._serve_params = serving_forward(
                    self.model.core, self.model.params, quantize=True)
        self.cl_epochs += 1
        # one fetch for the whole dict (a float() per key waits for the
        # device each time)
        values = torch.stack([v.to(torch.float32) for v in loss.values()]).cpu().tolist()
        loss = dict(zip(loss, values))
        loss["anomaly_score"] = self.anomaly_score
        loss["anomaly_score_ma"] = self.anomaly_score_ma
        self.last_epoch_loss = loss
        self.model_changed_flag = True
        if self.metrics is not None:
            self.metrics.log(self.cl_epochs, loss, prefix="cl/")
        return loss

    def set_learning_rate(self, lr: float) -> None:
        # the lr dial is a CL control: dialing it attaches the optimizer
        # (allocating its moments) if that has not happened yet
        self._ensure_cl()
        self.model.set_learning_rate(lr)

    def set_img_noise(self, beta: float) -> None:
        """The img-noise dial -> model.beta. beta only fuzzes the encoder
        input when encode() is called with training=True, and the training
        loss never does, so this dial is stored but has no effect on CL
        training, exactly as in the JAX engine."""
        self.model.beta = beta

    # ---------------------------------------------------------- replay buffer
    def load_replay_buffer_from_file(self, input_filename: str) -> int:
        """txt (one path per line) or csv (first column)."""
        return self.load_replay_buffer_from_filelist(parse_replay_file(input_filename))

    def load_replay_buffer_from_filelist(self, filelist: list) -> int:
        imgs, ok_paths = decode_filelist_to_model_res(
            filelist, self.height, self.width, self.channels, self.device)
        n = len(ok_paths)
        if n == 0:
            return 0
        if n > self.replay_capacity:
            # grow in RING_SIZE buckets, so that repeated oversized loads
            # converge to few distinct batch shapes
            self.replay_capacity = -(-n // self.RING_SIZE) * self.RING_SIZE
        buf = torch.zeros((self.replay_capacity, self.height, self.width, self.channels),
                          dtype=torch.float32, device=self.device)
        buf[:n] = imgs
        self.replay_buffer = buf
        self.replay_n = n
        self.replay_buffer_paths = ok_paths
        print(f"Replay Buffer Loaded: {n} images (capacity {self.replay_capacity})")
        return n

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


def parse_replay_file(input_filename: str) -> list:
    """Replay-buffer file -> the image paths in it that exist. txt (one path
    per line) or csv (first column)."""
    if not os.path.isfile(input_filename):
        raise FileNotFoundError(f"replay-buffer file not found: {input_filename}")
    ext = os.path.splitext(input_filename)[-1].lower()
    if ext == ".txt":
        with open(input_filename) as f:
            paths = [os.path.normpath(r.strip()) for r in f if r.strip()]
    elif ext == ".csv":
        with open(input_filename) as f:
            paths = [row[0] for row in csv.reader(f) if row]
    else:
        raise ValueError(f"Unrecognized extension: {ext}")
    return [p for p in paths if os.path.isfile(p)]


def decode_filelist_to_model_res(filelist: list, height: int, width: int, channels: int,
                                 device):
    """Worker-pool decode of a replay filelist, then normalize and antialias
    resize to model resolution on ``device``. Returns (float32 tensor
    (n, height, width, channels) on the device, absolute paths of the n
    readable files), in the list's order; unreadable files are skipped.
    Images are preprocessed in groups of one native shape, at most 32 at a
    time, so a large load never holds more than one chunk at camera size."""
    decoded = [(img, os.path.abspath(p)) for img, p in ParallelDecodeIterable(filelist)]
    out = torch.empty((len(decoded), height, width, channels), dtype=torch.float32,
                      device=device)
    by_shape: dict = {}
    for i, (img, _p) in enumerate(decoded):
        by_shape.setdefault(img.shape, []).append(i)
    chunk = 32
    for idxs in by_shape.values():
        for c0 in range(0, len(idxs), chunk):
            block = idxs[c0: c0 + chunk]
            stack = np.stack([decoded[i][0] for i in block])
            out[torch.as_tensor(block, device=device)] = preprocess_batch(
                stack, [height, width, channels], device)
    return out, [p for _img, p in decoded]
