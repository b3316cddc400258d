"""Device-side preprocessing and the double-buffered host-to-device transfer.

Counterpart of ``preprocess_batch`` and ``device_prefetch`` in
``trustedai_cl_vae_ad_tpu/data/ingest.py`` and of the resize in
``stream/engine.py`` (``jax.image.resize(method="linear", antialias=True)``,
the tf.image.resize(antialias=True) algorithm). ``F.interpolate`` with
``mode="bilinear", antialias=True, align_corners=False`` computes the same
triangle-kernel resize (tests/test_torch_resize.py pins it). The host ships
compact uint8 frames; the normalize and the resize run on the device.
``device_prefetch`` keeps ``depth`` batches in flight from a background
thread, so that decode and transfer overlap the training step. The device
cache (``DeviceCachedStream``) is ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_images(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of an NHWC float batch to ``out_hw``."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      antialias=True, align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


def _to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; through a pinned buffer and a
    non-blocking copy on a CUDA device, so the copy overlaps device work."""
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def preprocess_batch(batch: np.ndarray, image_size, device) -> torch.Tensor:
    """Normalize (uint8 -> float32 / 255; float input is already [0, 1]) and
    antialias-resize one batch on ``device``. ``image_size`` is the config's
    [W, H, C] triple; the resize targets (W, H) in tensor axes 1, 2."""
    x = _to_device(batch, torch.device(device))
    x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.to(torch.float32)
    return resize_images(x, (int(image_size[0]), int(image_size[1])))


_DONE = object()


def device_prefetch(batches: Iterable, image_size, device, depth: int = 2) -> Iterator[dict]:
    """Host batches -> dicts with 'image' on the device (float32, resized,
    normalized) and 'filepath' on the host, in order, ``depth`` in flight.

    A daemon thread runs the source and the preprocessing. It polls a stop
    flag while the queue is full, so a consumer that abandons the iteration
    releases the thread and its buffered device batches."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batches:
                img = batch["image"] if isinstance(batch, dict) else batch
                out = {"image": preprocess_batch(np.asarray(img), image_size, device)}
                if isinstance(batch, dict) and "filepath" in batch:
                    out["filepath"] = batch["filepath"]
                if not put(out):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises it
            err.append(e)
        finally:
            put(_DONE)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while not q.empty():  # let a producer blocked in put see the stop flag
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)
