"""On-disk saved-dataset format: npz shards plus an index.

The port's own copy of ``trustedai_cl_vae_ad_tpu/data/saved_dataset.py``
(numpy only; the flagship config's data source), reading and writing the same
directories:

    <dir>/index.json                 {"num_items", "shards", "format"}
    <dir>/shard_00000.npz            images: (N,H,W,C) uint8, filepaths: (N,) str

uint8 shards keep the host-to-device transfer compact; normalization happens
on the device (data/ingest.py). Shards load one at a time, so an epoch
streams without holding the dataset in memory.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, List, Optional

import numpy as np

INDEX_NAME = "index.json"


def save_dataset(
    out_dir: str,
    batches: Iterable,
    shard_size: int = 1024,
) -> dict:
    """Write batches of {'image': uint8 (B,H,W,C), 'filepath': [str]} to shards."""
    os.makedirs(out_dir, exist_ok=True)
    buf_imgs: List[np.ndarray] = []
    buf_paths: List[str] = []
    shards = []
    count = 0

    def flush():
        nonlocal buf_imgs, buf_paths
        if not buf_imgs:
            return
        images = np.concatenate(buf_imgs, axis=0)
        shard_name = f"shard_{len(shards):05d}.npz"
        np.savez(
            os.path.join(out_dir, shard_name),
            images=images,
            filepaths=np.asarray(buf_paths),
        )
        shards.append({"file": shard_name, "num_items": int(images.shape[0])})
        buf_imgs, buf_paths = [], []

    for batch in batches:
        if isinstance(batch, dict):
            img = np.asarray(batch["image"])
            paths = list(batch.get("filepath", [""] * len(img)))
        else:
            img = np.asarray(batch)
            paths = [""] * len(img)
        if img.dtype != np.uint8:
            # Normalized [0,1] float batches — the loaders' device-stream
            # contract — would collapse to {0,1} under a bare round; rescale
            # them to the 0-255 storage range first. (Heuristic: an all-dark
            # 0-255 float image with max <= 1 also rescales, which is the
            # lossless direction for it anyway.)
            if (np.issubdtype(img.dtype, np.floating) and img.size
                    and float(img.min()) >= 0.0 and float(img.max()) <= 1.0):
                img = img * 255.0
            img = np.clip(np.round(img), 0, 255).astype(np.uint8)
        buf_imgs.append(img)
        buf_paths.extend(str(p) for p in paths)
        count += len(img)
        if sum(b.shape[0] for b in buf_imgs) >= shard_size:
            flush()
    flush()

    index = {"num_items": count, "shards": shards, "format": "npz-u8-v1"}
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump(index, f, indent=1)
    return index


class SavedDataset:
    """Lazily stream batches from a saved dataset directory.

    ``shuffle=True`` reshuffles every epoch (a fresh permutation per
    ``__iter__``): shard order is permuted and items are permuted within each
    shard: an O(shard)-memory approximation of global shuffling, the same
    trade a shuffle buffer makes.
    """

    def __init__(self, path: str, batch_size: int = 32, shuffle: bool = False, seed: int = 0):
        index_path = os.path.join(path, INDEX_NAME)
        if not os.path.isfile(index_path):
            raise FileNotFoundError(f"not a saved dataset (no {INDEX_NAME}): {path}")
        with open(index_path) as f:
            self.index = json.load(f)
        self.path = path
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return (self.index["num_items"] + self.batch_size - 1) // self.batch_size

    @property
    def num_items(self) -> int:
        return self.index["num_items"]

    def __iter__(self) -> Iterator[dict]:
        carry_img: Optional[np.ndarray] = None
        carry_paths: list = []
        shards = list(self.index["shards"])
        if self.shuffle:
            self._rng.shuffle(shards)
        for shard in shards:
            with np.load(os.path.join(self.path, shard["file"]), allow_pickle=False) as z:
                images = z["images"]
                paths = [str(p) for p in z["filepaths"]]
            if self.shuffle:
                perm = self._rng.permutation(len(images))
                images = images[perm]
                paths = [paths[i] for i in perm]
            if carry_img is not None:
                images = np.concatenate([carry_img, images], axis=0)
                paths = carry_paths + paths
                carry_img, carry_paths = None, []
            n_full = (len(images) // self.batch_size) * self.batch_size
            for i in range(0, n_full, self.batch_size):
                yield {
                    "image": images[i : i + self.batch_size],
                    "filepath": paths[i : i + self.batch_size],
                }
            if n_full < len(images):
                carry_img = images[n_full:]
                carry_paths = paths[n_full:]
        if carry_img is not None and len(carry_img):
            yield {"image": carry_img, "filepath": carry_paths}


def is_saved_dataset(path: str) -> bool:
    return os.path.exists(os.path.join(path, INDEX_NAME))
