"""Device-side preprocessing and the double-buffered host-to-device transfer.

Counterpart of ``preprocess_batch`` and ``device_prefetch`` in
``trustedai_cl_vae_ad_tpu/data/ingest.py`` and of the resize in
``stream/engine.py`` (``jax.image.resize(method="linear", antialias=True)``,
the tf.image.resize(antialias=True) algorithm). ``F.interpolate`` with
``mode="bilinear", antialias=True, align_corners=False`` computes the same
triangle-kernel resize (tests/test_torch_resize.py pins it). The host ships
compact uint8 frames; the normalize and the resize run on the device.
``device_prefetch`` keeps ``depth`` batches in flight from a background
thread, so that decode and transfer overlap the training step.
``DeviceCachedStream`` (``data.device_cache``) keeps the preprocessed
batches of the first epoch in device memory, so later epochs never touch the
host, within a byte budget (``DeviceCacheBudget``) that the streams of one
dataset share.
"""

from __future__ import annotations

import threading
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trustedai_cl_vae_ad_tpu_torch.data.pipeline import BackgroundPrefetcher


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


def device_prefetch(batches: Iterable, image_size, device, depth: int = 2) -> Iterator[dict]:
    """Host batches -> dicts with 'image' on the device (float32, resized,
    normalized) and 'filepath' on the host, in order, ``depth`` in flight:
    a ``BackgroundPrefetcher`` thread runs the source and the preprocessing,
    and a consumer that abandons the iteration releases it."""

    def produce():
        for batch in batches:
            img = batch["image"] if isinstance(batch, dict) else batch
            out = {"image": preprocess_batch(np.asarray(img), image_size, device)}
            if isinstance(batch, dict) and "filepath" in batch:
                out["filepath"] = batch["filepath"]
            yield out

    return iter(BackgroundPrefetcher(produce(), depth=depth))


class DeviceCacheBudget:
    """The device-memory byte budget of the caches of ONE dataset:
    ``data.device_cache_max_gb`` caps the train and validation streams of a
    ``load_data`` call together, so they share one instance. Thread-safe:
    caches fill inside prefetcher threads."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._used = 0
        self._lock = threading.Lock()

    @property
    def used(self) -> int:
        return self._used

    def take(self, n: int) -> bool:
        with self._lock:
            if self._used + n > self.max_bytes:
                return False
            self._used += n
            return True

    def release(self, n: int) -> None:
        with self._lock:
            self._used -= n


class DeviceCachedStream:
    """A dataset held in device memory: decode and upload once, then train
    from the device.

    The first iteration is ``device_prefetch``'s stream, and it keeps each
    preprocessed batch (float32, resized, normalized, on the device) while
    the budget allows; once it has run to its end, every later iteration
    yields the kept batches and touches neither the host's decode nor the
    host-to-device copy. When a batch would pass the budget, the batches
    kept so far are dropped and released, the stream goes on from the host
    for the rest of that epoch and for every later one, and it says so once:
    the dataset does not fit beside the model, as in the JAX package. The
    device stays the device either way. One iteration fills at a time (others
    that run meanwhile stream from the host), and a fill abandoned mid-epoch
    returns its reservation. A cached epoch gives the very tensors of the
    streamed one; it freezes the first epoch's batch order (a shuffled source
    is not reshuffled)."""

    def __init__(self, source, image_size, device, depth: int = 2, max_bytes: int = 4 << 30,
                 budget: Optional[DeviceCacheBudget] = None, log=print):
        self.source = source
        self.image_size = image_size
        self.device = device
        self.depth = depth
        self.budget = budget if budget is not None else DeviceCacheBudget(max_bytes)
        self.log = log
        self._cache: Optional[list] = None
        self._gave_up = False
        self._filling = False
        self._lock = threading.Lock()

    def __len__(self):
        if self._cache is not None:
            return len(self._cache)
        return len(self.source)

    @property
    def cached(self) -> bool:
        return self._cache is not None

    @property
    def nbytes(self) -> int:
        """Bytes of the cached batches' images (0 until the cache is filled)."""
        if self._cache is None:
            return 0
        return sum(b["image"].numel() * b["image"].element_size() for b in self._cache)

    def _host_stream(self) -> Iterator[dict]:
        return device_prefetch(iter(self.source), self.image_size, self.device, depth=self.depth)

    def __iter__(self) -> Iterator[dict]:
        with self._lock:
            if self._cache is not None:
                return iter(self._cache)
            fill = not (self._gave_up or self._filling)
            if fill:
                self._filling = True
        return self._fill_iter() if fill else self._host_stream()

    def _fill_iter(self) -> Iterator[dict]:
        items: list = []
        used = 0
        committed = False
        try:
            for batch in self._host_stream():
                if not self._gave_up:
                    image = batch["image"]
                    nbytes = image.numel() * image.element_size()
                    if self.budget.take(nbytes):
                        used += nbytes
                        items.append(batch)
                    else:
                        self._gave_up = True
                        self.budget.release(used)
                        used = 0
                        items = []
                        self.log(f"DeviceCachedStream: the dataset passes the "
                                 f"{self.budget.max_bytes / (1 << 30):g} GiB device-cache budget; "
                                 "it streams from the host (data.device_cache_max_gb raises "
                                 "the budget)")
                yield batch
            if not self._gave_up:
                self._cache = items
                committed = True
        finally:
            if not committed and used:
                self.budget.release(used)
            self._filling = False
