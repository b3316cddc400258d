"""Host-side image decode: one file, and a list of files on a thread pool.

Counterpart of ``decode_image_rgb`` and ``ParallelDecodeIterable`` in
``trustedai_cl_vae_ad_tpu/data/pipeline.py``, as far as the live engine's
replay-buffer loader needs them (numpy and threads only). Decode fans out
over a thread pool (cv2 releases the GIL in imread) with a bounded reorder
buffer. The JAX package's native C++ decoder is not used here: the chain is
cv2, then PIL. Batching, caching and the background prefetcher of that module
have their counterparts in ``data/ingest.py`` and ``data/loader.py``.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
from typing import Callable, Iterator, Optional, Sequence

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
