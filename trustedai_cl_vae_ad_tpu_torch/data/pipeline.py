"""Host-side input pipeline: decode, batching, caching and prefetch.

Counterpart of ``trustedai_cl_vae_ad_tpu/data/pipeline.py`` (numpy and
threads only): ``decode_image_rgb`` and ``ParallelDecodeIterable`` (decode
fans out over a thread pool, as cv2 releases the GIL in imread, with a bounded
reorder buffer; the JAX package's native C++ decoder is not used here: the
chain is cv2, then PIL), ``batched`` (frames into {'image', 'filepath'}
batches), ``CachedDataset`` (decoded batches kept in host memory after the
first pass), ``BackgroundPrefetcher`` (an iterator run ahead in a thread) and
``MappedDataset`` (a lazy per-batch map).
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np


def decode_image_rgb(filepath: str) -> Optional[np.ndarray]:
    """Read an image file to RGB uint8 HWC: cv2, then PIL; None when neither
    can read it."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(filepath)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        # cv2 failing to decode is not the end of the chain: PIL reads some
        # files (16-bit PNG, CMYK JPEG) that cv2 does not
    from PIL import Image

    try:
        with Image.open(filepath) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:
        return None


class ParallelDecodeIterable:
    """Decode a list of filepaths with a worker pool, preserving order.

    Yields (image uint8 HWC, filepath); silently skips unreadable files.
    """

    def __init__(
        self,
        filepaths: Sequence[str],
        decode_fn: Callable[[str], Optional[np.ndarray]] = decode_image_rgb,
        num_workers: int = 8,
        prefetch: int = 32,
    ):
        self.filepaths = list(filepaths)
        self.decode_fn = decode_fn
        self.num_workers = num_workers
        self.prefetch = max(prefetch, num_workers)

    def __len__(self):
        return len(self.filepaths)

    def __iter__(self) -> Iterator:
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: "queue.Queue" = queue.Queue()
            it = iter(self.filepaths)

            def submit_next() -> bool:
                try:
                    fp = next(it)
                except StopIteration:
                    return False
                pending.put((pool.submit(self.decode_fn, fp), fp))
                return True

            for _ in range(self.prefetch):
                if not submit_next():
                    break
            while not pending.empty():
                fut, fp = pending.get()
                img = fut.result()
                submit_next()
                if img is None:
                    continue
                yield img, fp


def batched(source: Iterable, batch_size: int, drop_remainder: bool = False) -> Iterator[dict]:
    """(image, filepath) pairs -> {'image': (B, H, W, C) uint8, 'filepath':
    [str]} batches. A change of image shape ends the batch early (a ragged
    dataset), except under ``drop_remainder``, which never yields a partial
    batch."""
    images: List[np.ndarray] = []
    paths: List[str] = []
    for img, fp in source:
        if images and img.shape != images[0].shape:
            if not drop_remainder:
                yield {"image": np.stack(images), "filepath": paths}
            images, paths = [], []
        images.append(img)
        paths.append(fp if isinstance(fp, str) else str(fp))
        if len(images) == batch_size:
            yield {"image": np.stack(images), "filepath": paths}
            images, paths = [], []
    if images and not drop_remainder:
        yield {"image": np.stack(images), "filepath": paths}


class CachedDataset:
    """Materialize once, iterate many times: the first full pass over
    ``factory()`` keeps its batches, later passes replay them.

    ``sized_source`` answers ``len()`` before the cache is filled (in O(1),
    e.g. from a path list); without it ``len()`` would decode the whole
    dataset to count its batches."""

    def __init__(self, factory: Callable[[], Iterable], sized_source=None):
        self._factory = factory
        self._sized_source = sized_source
        self._cache: Optional[List] = None
        self._lock = threading.Lock()

    def __iter__(self):
        if self._cache is not None:
            return iter(self._cache)
        return self._fill_iter()

    def _fill_iter(self):
        items = []
        for item in self._factory():
            items.append(item)
            yield item
        with self._lock:
            self._cache = items

    def __len__(self):
        if self._cache is not None:
            return len(self._cache)
        if self._sized_source is not None and hasattr(self._sized_source, "__len__"):
            return len(self._sized_source)
        self._cache = list(self._factory())
        return len(self._cache)


class BackgroundPrefetcher:
    """Run an iterable in a daemon thread, ``depth`` items ahead, in order.

    An error in the thread is raised in the consumer. The thread polls a stop
    flag while the queue is full, so a consumer that abandons the iteration
    (``break``, an exception, garbage collection) releases the thread and the
    items it buffered (device batches, where it makes them)."""

    _DONE = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = depth

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
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
                for item in self.iterable:
                    if not put(item):
                        return
            except BaseException as e:  # handed to the consumer, which re-raises it
                err.append(e)
            finally:
                put(self._DONE)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
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


class MappedDataset:
    """A lazy per-batch map over a re-iterable source."""

    def __init__(self, source: Iterable, fn: Callable):
        self.source = source
        self.fn = fn

    def __iter__(self):
        for item in self.source:
            yield self.fn(item)

    def __len__(self):
        return len(self.source)
