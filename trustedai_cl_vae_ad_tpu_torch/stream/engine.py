"""Headless single-stream inference and continual-learning engine.

Counterpart of ``trustedai_cl_vae_ad_tpu/stream/engine.py::StreamingEngine``:

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
  * recording: every ``record_period_ms`` a tick writes five PNG streams
    (frames, err, heatmap, overlay, rec) into a ``data_<timestamp>``
    instance directory, and ``terminate_recording`` closes it with a COCO
    ``labels.json`` of the frames' anomaly scores and a model snapshot;
  * autosave into ``model_cache_dir``: the period only SETS a schedule flag,
    each frame consumes the flag and saves iff continual learning dirtied the
    model (``autosave_cycle``); ``async_autosave`` writes the round in the
    background after the copy off the device (``train/checkpoint.py::
    AsyncSaver``). A save writes the checkpoint round, ``config.yml`` with
    ``cam_info`` embedded and ``replay_buffer_paths.csv``;
    ``load_engine_from_directory`` boots an engine from such a directory,
    Adam's moments included, and ``combine_datasets`` merges recordings;
  * the per-phase ``timings`` dict.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import shutil
import time
from collections import deque
from copy import deepcopy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.anomaly.cdf import CDFObject, threshold_from_cdf
from trustedai_cl_vae_ad_tpu_torch.config import load_config, save_config
from trustedai_cl_vae_ad_tpu_torch.data.ingest import preprocess_batch, resize_images
from trustedai_cl_vae_ad_tpu_torch.data.pipeline import ParallelDecodeIterable
from trustedai_cl_vae_ad_tpu_torch.ops import moments, stream_score
from trustedai_cl_vae_ad_tpu_torch.ops.quant import QuantizedServingModel, serving_forward
from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState
from trustedai_cl_vae_ad_tpu_torch.utils.profiling import defer_signals

RECORD_STREAMS = ("frames", "err", "heatmap", "overlay", "rec")


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


class AutosaveControls:
    """The autosave controls both live engines share. The engine provides
    ``model``, ``model_cache_dir``, ``autosave_period_s``, ``async_autosave``,
    ``_async_saver``, ``_last_autosave_t``, ``schedule_model_save_flag``,
    ``model_changed_flag`` and ``save_model_to_dir(model_dir, saver=None)``."""

    def _get_async_saver(self):
        """The engine's AsyncSaver when ``async_autosave`` is on, made at the
        first autosave (an engine that never autosaves starts no writer)."""
        if not self.async_autosave:
            return None
        if self._async_saver is None:
            from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import AsyncSaver

            self._async_saver = AsyncSaver()
        return self._async_saver

    def drain_autosaves(self) -> None:
        """Wait until the background autosave in flight (if any) is written
        and committed, and release the saver. Call before the process exits:
        a write cut off by the interpreter's teardown is a lost round. When
        the write failed, the model is marked dirty again before the error is
        raised, so the caller can still save it synchronously."""
        saver, self._async_saver = self._async_saver, None
        if saver is None:
            return
        try:
            saver.close()
        except Exception:
            self.model_changed_flag = True  # the failed round is not on disk
            raise

    def schedule_model_save(self) -> None:
        """Save to the cache at the next tick IF the model is dirty (the flag
        is consumed either way)."""
        self.schedule_model_save_flag = True

    def schedule_model_save_override(self) -> None:
        """Save to the cache at the next tick even if the model is clean."""
        self.schedule_model_save_flag = True
        self.model_changed_flag = True

    def _maybe_autosave(self, now: float) -> None:
        autosave_cycle(self, now)


class StreamingEngine(AutosaveControls):
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
        autosave_period_s: float = 5 * 60.0,
        async_autosave: bool = False,
    ):
        self.model = model
        self.config = config
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

        # autosave (AutosaveControls): the period sets the schedule flag,
        # which starts set; its clock is seeded from the first frame's (wall
        # or injected) time. ``async_autosave`` backgrounds the periodic
        # cache write after the copy off the device; explicit saves and the
        # recording snapshot stay synchronous. drain_autosaves() before exit.
        self.model_cache_dir = model_cache_dir
        self.autosave_period_s = float(autosave_period_s)
        self.async_autosave = bool(async_autosave)
        self._async_saver = None
        self.schedule_model_save_flag = True
        self._last_autosave_t: Optional[float] = None

        # recording
        self.record_dir: Optional[str] = None
        self.record_instance_dir: Optional[str] = None
        self.recording_flag = False
        self.anomaly_score_map: dict = {}
        self._last_record_t = 0.0
        self.record_period_ms = 500.0

        self.process_rate = 0.0
        self.timings: dict = {}

        self._forward, self._serve_params = serving_forward(
            model.core, model.params, quantize=self.quantized, qparams=qparams)

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
            n = self.RING_SIZE + (0 if self.replay_buffer is None else self.replay_buffer.shape[0])
            warm_cl_backward(self.model, n, (self.height, self.width, self.channels))

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
        record_frame = frame_u8
        if self.pipelined:
            # the raw frame and its tag travel with the frame's result, so a
            # recording pairs frame N-1's image with frame N-1's score
            pending, self._pending = self._pending, (score_count, norm_u8, rec_u8, frame_u8, tag)
            if pending is None:
                return None  # the first frame's result arrives next call
            score_count, norm_u8, rec_u8, record_frame, tag = pending
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
        self._maybe_record(record_frame, result, now)
        self._maybe_autosave(now)

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
        score_count, norm_u8, rec_u8, record_frame, tag = self._pending
        self._pending = None
        score, count = score_count.cpu().numpy()
        result = self._finish(float(score), float(count), norm_u8, rec_u8, tag, now)
        self._maybe_record(record_frame, result, now)
        return result

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
        return cl_batch(self.ring, torch.ones(self.RING_SIZE, device=self.device),
                        self.replay_buffer, self.replay_n)

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

    # -------------------------------------------------------------- recording
    def begin_recording(self, record_dir: str) -> str:
        """Open a ``data_<timestamp>`` instance directory under ``record_dir``
        (which must exist) with the five PNG streams; returns its path."""
        if not os.path.isdir(record_dir):
            raise NotADirectoryError(f"record directory not found: {record_dir}")
        self.record_dir = record_dir
        start_time = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        self.record_instance_dir = os.path.join(record_dir, f"data_{start_time}")
        for sub in RECORD_STREAMS:
            os.makedirs(os.path.join(self.record_instance_dir, sub))
        self.anomaly_score_map = {}
        self.recording_flag = True
        print(f"Recording to: {self.record_instance_dir}")
        return self.record_instance_dir

    def _maybe_record(self, frame_u8: np.ndarray, result: FrameResult, now: float) -> None:
        """Every ``record_period_ms``: write the frame's five PNGs. Only a tick
        that records fetches the error map and the reconstruction."""
        if not self.recording_flag:
            return
        if (now - self._last_record_t) * 1000.0 < self.record_period_ms:
            return
        self._last_record_t = now
        basename = datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f") + ".png"
        self.anomaly_score_map[basename] = result.score
        record_frame_artifacts(self.record_instance_dir, basename, frame_u8,
                               result.norm_err_u8, result.reconstruction_u8,
                               self.height, self.width)

    def terminate_recording(self) -> Optional[str]:
        """Close the recording: a COCO ``labels.json`` with the recorded
        frames' anomaly scores, and a synchronous model snapshot in
        ``<instance>/model``. Returns the labels' path (None if nothing was
        opened)."""
        self.recording_flag = False
        d = self.record_instance_dir
        if d is None or not os.path.isdir(d):
            return None
        labels_filename = write_coco_labels(d, self.anomaly_score_map)
        self.save_model_to_dir(os.path.join(d, "model"))
        return labels_filename

    # ------------------------------------------------------------ model save
    def save_model_to_dir(self, model_dir: str, saver=None) -> str:
        """Checkpoint round + ``config.yml`` with ``cam_info`` embedded +
        ``replay_buffer_paths.csv``. ``saver`` (an AsyncSaver) writes the
        round in the background; ``autosave_cycle`` passes the engine's."""
        return save_model_dir(self.model, self.config, model_dir, cam_info=self.cam_info,
                              replay_paths=self.replay_buffer_paths, saver=saver)

    def save_model_to_dir_by_date(self, model_dir: str) -> str:
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        return self.save_model_to_dir(os.path.join(os.path.abspath(model_dir), f"date_{stamp}"))


def record_frame_artifacts(instance_dir: str, basename: str, frame_u8: np.ndarray,
                           norm_err_u8: np.ndarray, reconstruction_u8: np.ndarray,
                           height: int, width: int) -> None:
    """Write one tick's five PNG streams into an instance directory. The
    overlay blends the heatmap with the model-size INPUT frame (resized on
    the host, PIL bilinear, when the camera delivers another size), not the
    reconstruction. Shared by the single-stream and multi-camera engines."""
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import jet_heatmap, overlay_heatmap, save_rgb

    heatmap = jet_heatmap(norm_err_u8)
    base_img = frame_u8
    if base_img.shape[:2] != (height, width):
        from PIL import Image

        # PIL makes no image of (H, W, 1): squeeze, resize, restore the axis
        single = base_img.ndim == 3 and base_img.shape[-1] == 1
        base_img = np.asarray(
            Image.fromarray(base_img[..., 0] if single else base_img)
            .resize((width, height), Image.BILINEAR), np.uint8)
        if single:
            base_img = base_img[..., None]
    overlay = overlay_heatmap(norm_err_u8, base_img)
    for sub, arr in zip(RECORD_STREAMS,
                        (frame_u8, norm_err_u8, heatmap, overlay, reconstruction_u8)):
        save_rgb(arr, os.path.join(instance_dir, sub, basename))


def write_coco_labels(instance_dir: str, anomaly_score_map: dict) -> str:
    """COCO ``labels.json`` over ``instance_dir/frames`` with one anomaly-score
    annotation per recorded frame; returns its path. Shared by both engines."""
    from PIL import Image

    img_filelist = []
    for dirpath, _, filenames in os.walk(os.path.join(instance_dir, "frames")):
        for f in sorted(filenames):
            if os.path.splitext(f)[1].lower() == ".png":
                img_filelist.append(os.path.join(dirpath, f))
    output_dict = {
        "info": {
            "year": datetime.datetime.now().year,
            "version": "1.0",
            "description": "custom",
            # the JAX recorder's contributor: both packages' recordings merge alike
            "contributor": "trustedai_cl_vae_ad_tpu",
        },
        "categories": [],
        "images": [],
        "annotations": [],
    }
    for idx, img_filepath in enumerate(img_filelist):
        with Image.open(img_filepath) as img:
            width, height = img.size
        img_basename = os.path.basename(img_filepath)
        output_dict["images"].append(
            {"id": idx, "width": width, "height": height, "file_name": img_basename})
        score = anomaly_score_map.get(img_basename)
        if score is not None:
            output_dict["annotations"].append({img_basename: score})
    labels_filename = os.path.join(instance_dir, "labels.json")
    with open(labels_filename, "w") as f:
        json.dump(output_dict, f)
    return labels_filename


def save_model_dir(model, config: dict, model_dir: str, cam_info=None, replay_paths=None,
                   saver=None) -> str:
    """The log-directory save both engines share: the checkpoint round, then
    ``config.yml`` (with ``cam_info`` embedded) and the replay provenance
    ``replay_buffer_paths.csv``. With ``saver`` the round is written in the
    background (the sidecars are small host writes and stay synchronous).
    An int8-boot ``QuantizedServingModel`` takes the plain save, which
    persists its quantized tree."""
    os.makedirs(model_dir, exist_ok=True)
    if saver is not None and not isinstance(model, QuantizedServingModel):
        model.save_model(model_dir, saver=saver)
    else:
        model.save_model(model_dir)
    output_config = deepcopy(config)
    if cam_info:
        output_config["cam_info"] = cam_info
    save_config(output_config, os.path.join(model_dir, "config.yml"))
    if replay_paths:
        with open(os.path.join(model_dir, "replay_buffer_paths.csv"), "w", newline="") as f:
            writer = csv.writer(f)
            for row in replay_paths:
                writer.writerow([row])
    print(f"Saved Model to {model_dir}")
    return model_dir


def autosave_cycle(eng, now: float) -> None:
    """The autosave state machine both engines share (``AutosaveControls``):
    the period only SETS the schedule flag; each tick consumes the flag and
    saves iff the model is dirty. A failed save (a full disk, or a background
    write of the previous round that failed, which the saver raises at this
    save) is reported, leaves the model DIRTY so that the next schedule
    retries, and never stops the frame loop."""
    if eng.model_cache_dir is None:
        return
    if eng._last_autosave_t is None:
        eng._last_autosave_t = now
    if now - eng._last_autosave_t >= eng.autosave_period_s:
        eng._last_autosave_t = now
        eng.schedule_model_save_flag = True
    if not eng.schedule_model_save_flag:
        return
    eng.schedule_model_save_flag = False
    if not eng.model_changed_flag:
        return
    try:
        eng.save_model_to_dir(eng.model_cache_dir, saver=eng._get_async_saver())
    except Exception as e:  # noqa: BLE001: the frame loop must keep running
        print(f"autosave failed (will retry at the next schedule): {e!r}")
        eng.model_changed_flag = True
        return
    eng.model_changed_flag = False


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


def cl_batch(rows: torch.Tensor, row_weights: torch.Tensor, replay_buffer: Optional[torch.Tensor],
             replay_n: int):
    """(stacked frames, row weights) of one continual-learning step: the
    engine's recent frames with their weights, then the capacity-padded
    replay buffer, whose first ``replay_n`` rows weigh 1 and the padding 0.
    Shared by the single-stream ring and the fleet ring."""
    if replay_buffer is None:
        return rows, row_weights
    replay_weights = torch.zeros(replay_buffer.shape[0], device=row_weights.device)
    replay_weights[:replay_n] = 1.0
    return (torch.cat([rows, replay_buffer], dim=0),
            torch.cat([row_weights, replay_weights], dim=0))


def warm_cl_backward(model, n: int, shape) -> None:
    """Build the moments kernels and run a continual-learning step's loss
    and backward once on a scratch batch of n rows at ``shape`` (H, W, C),
    so that the first real step pays neither the builds nor the first-call
    costs. The gradients are dropped: parameters, moments and the model's
    generator stay as they were. Mid-grey rows, not zeros: an all-zero
    latent has no z_l2 gradient."""
    if model.device.type == "cuda":
        moments.build()
    stacked = torch.full((n, *shape), 0.5, dtype=torch.float32, device=model.device)
    eps = torch.zeros((n, model.latent_size), device=model.device)
    loss = model.core.compute_loss(stacked, training=True, eps=eps,
                                   weights=torch.ones(n, device=model.device))["loss"]
    grads = torch.autograd.grad(loss, model.optimizer.params)
    float(grads[0].flatten()[0])  # wait for the backward


def boot_serving_model(log_dir: str, device="cuda", quantize: bool = False,
                       int8_checkpoint_boot: bool = False, restore_optimizer: bool = True,
                       log=print):
    """(model, config, qparams) of a serving surface booted from a log
    directory; the one place that holds the boot rules. With ``quantize``
    and ``int8_checkpoint_boot``, a ``<log_dir>/quantized`` sidecar
    (tools/quantize_checkpoint_torch.py) boots the model from the int8 tree:
    the float parameters are neither read nor put on the device (a
    ``QuantizedServingModel``, inference only), ``qparams`` is that tree, and
    a sidecar older than the float checkpoint beside it is reported
    (``quantized_staleness``). Otherwise the float model is loaded, with its
    Adam moments when ``restore_optimizer`` and the directory holds them (a
    continual-learning resume), and ``qparams`` is None."""
    from trustedai_cl_vae_ad_tpu_torch.ops.quant import (
        has_quantized_checkpoint,
        load_int8_serving_model,
    )
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    if quantize and int8_checkpoint_boot:
        if has_quantized_checkpoint(log_dir):
            model, config = load_int8_serving_model(log_dir, device=device, log=log)
            return model, config, model.qparams
        log(f"no quantized checkpoint under {log_dir}: float boot "
            "(tools/quantize_checkpoint_torch.py writes one)")
    model, config = load_model_from_directory(log_dir, device=device,
                                              restore_optimizer=restore_optimizer)
    return model, config, None


def load_engine_from_directory(log_dir: str, int8_checkpoint_boot: bool = False, device="cuda",
                               **kwargs) -> StreamingEngine:
    """A StreamingEngine over the model of a log directory
    (``boot_serving_model``: the weights and, when saved, Adam's moments in
    one read; an int8 boot with ``quantize=True`` and
    ``int8_checkpoint_boot``), with the ``cam_info`` of its ``config.yml``
    and its ``replay_buffer_paths.csv`` loaded when present. ``kwargs`` go to
    the engine."""
    model, config, qparams = boot_serving_model(
        log_dir, device, quantize=bool(kwargs.get("quantize")),
        int8_checkpoint_boot=int8_checkpoint_boot)
    kwargs.setdefault("cam_info", config.get("cam_info"))
    engine = StreamingEngine(model, config, qparams=qparams, **kwargs)
    replay_csv = os.path.join(log_dir, "replay_buffer_paths.csv")
    if os.path.exists(replay_csv):
        engine.load_replay_buffer_from_file(replay_csv)
    return engine


def combine_datasets(src_dirs: list, dest_dir: str) -> str:
    """Merge recorded datasets into ``dest_dir`` (which must exist): copy
    every source tree that holds a ``labels.json``, and write one
    ``labels.json`` whose images are all the sources' in order. Returns its
    path."""
    if not os.path.isdir(dest_dir):
        raise NotADirectoryError(f"destination not found: {dest_dir}")
    labels = []
    for src_dir in src_dirs:
        label_filepath = os.path.join(src_dir, "labels.json")
        if not os.path.exists(label_filepath):
            continue
        with open(label_filepath) as f:
            labels.append(json.load(f))
        for root_path, _dirs, files in os.walk(src_dir):
            d_dir = root_path.replace(src_dir, dest_dir, 1)
            os.makedirs(d_dir, exist_ok=True)
            for f in files:
                dst_file = os.path.join(d_dir, f)
                if os.path.exists(dst_file):
                    os.remove(dst_file)
                shutil.copy(os.path.join(root_path, f), d_dir)
    if not labels:
        raise FileNotFoundError("no labels.json found in any source directory")
    output_label = deepcopy(labels[0])
    for label_obj in labels[1:]:
        output_label["images"].extend(label_obj["images"])
    out_path = os.path.join(dest_dir, "labels.json")
    with open(out_path, "w") as f:
        json.dump(output_label, f)
    return out_path
