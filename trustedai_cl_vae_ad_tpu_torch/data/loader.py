"""``load_data(config)``: dataset front end keyed by the config's data section.

Counterpart of ``trustedai_cl_vae_ad_tpu/data/loader.py`` for two of its
sources:

  * ``dataset_path`` -> a saved dataset directory (data/saved_dataset.py)
    with ``train/`` and ``validation/`` subdirectories, or a single split;
  * ``dataset: synthetic`` -> seeded noise frames (``n_train``, ``n_val``;
    ``synthetic_frame_size: [W, H]`` makes the frames at another size than
    ``image_size``, so that the device resize runs).

``dataset: raite`` and catalog names raise: RAITE/COCO ingest is ROADMAP
queue 1 item 1. Returns {'train', 'val'}; each split yields dict batches
whose 'image' is already on the device: float32, [0, 1], resized to the
config's image_size (data/ingest.py).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from trustedai_cl_vae_ad_tpu_torch.data import ingest
from trustedai_cl_vae_ad_tpu_torch.data.saved_dataset import SavedDataset, is_saved_dataset


class DeviceStream:
    """Re-iterable wrapper: host batch source -> device-preprocessed batches."""

    def __init__(self, source, image_size, device, depth: int = 2):
        self.source = source
        self.image_size = image_size
        self.device = device
        self.depth = depth

    def __iter__(self) -> Iterator[dict]:
        return ingest.device_prefetch(iter(self.source), self.image_size, self.device,
                                      depth=self.depth)

    def __len__(self):
        return len(self.source)


class SyntheticDataset:
    """Deterministic noise frames for tests and benchmarks."""

    def __init__(self, n: int, image_size, batch_size: int, seed: int = 0):
        self.n = n
        self.image_size = list(image_size)
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        remaining = self.n
        idx = 0
        w, h, c = self.image_size
        while remaining > 0:
            b = min(self.batch_size, remaining)
            img = rng.randint(0, 256, size=(b, w, h, c), dtype=np.uint8)
            paths = [f"synthetic://{self.seed}/{idx + i}" for i in range(b)]
            yield {"image": img, "filepath": paths}
            idx += b
            remaining -= b


def iter_images(dataset):
    """Yield the images of batches that may be dicts ('image' key), tuples
    (first element) or raw arrays: the one definition of the batch contract."""
    for batch in dataset:
        if isinstance(batch, dict):
            yield batch["image"]
        elif isinstance(batch, (tuple, list)):
            yield batch[0]
        else:
            yield batch


def host_images(images) -> np.ndarray:
    """Images from ``iter_images`` on the host as a numpy array, whatever the
    source gave (a tensor on any device, or an array); uint8 frames are raw
    0-255 pixels and come back as float32 in [0, 1]."""
    if hasattr(images, "detach"):
        images = images.detach().cpu().numpy()
    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    return images


def load_data(config: dict, device="cuda") -> dict:
    data_config = config["data"]
    dataset_path = data_config.get("dataset_path")
    dataset_name = data_config.get("dataset")
    img_size = data_config["image_size"]
    batch_size = int(config["training"]["batch_size"])

    def _stream(source):
        return DeviceStream(source, img_size, device)

    if dataset_name == "raite":
        raise NotImplementedError(
            "data.dataset: raite is not ported yet (ROADMAP.md queue 1 item 1: RAITE/COCO "
            "ingest); use dataset_path (a saved dataset directory) or dataset: synthetic")

    if dataset_path is not None:
        print(f"Loading dataset from: {dataset_path}")
        if not os.path.isdir(dataset_path):
            raise FileNotFoundError(f"data.dataset_path is not a directory: {dataset_path}")
        train_dir = os.path.join(dataset_path, "train")
        val_dir = os.path.join(dataset_path, "validation")
        # deterministic by default; the training CLI opts in to shuffling
        shuffle = bool(data_config.get("shuffle", False))
        if is_saved_dataset(dataset_path) and not os.path.exists(train_dir):
            train_ds = SavedDataset(dataset_path, batch_size, shuffle=shuffle)
            val_ds: Optional[SavedDataset] = None
        else:
            train_ds = SavedDataset(train_dir, batch_size, shuffle=shuffle)
            val_ds = SavedDataset(val_dir, batch_size) if os.path.exists(val_dir) else None
        return {"train": _stream(train_ds),
                "val": _stream(val_ds) if val_ds is not None else None}

    if dataset_name == "synthetic":
        n_train = int(data_config.get("n_train", 256))
        n_val = int(data_config.get("n_val", 64))
        frame_size = list(img_size)
        if data_config.get("synthetic_frame_size"):
            frame_size[:2] = [int(v) for v in data_config["synthetic_frame_size"]]
        return {
            "train": _stream(SyntheticDataset(n_train, frame_size, batch_size, seed=0)),
            "val": _stream(SyntheticDataset(n_val, frame_size, batch_size, seed=1)),
        }

    if dataset_name is not None:
        raise NotImplementedError(
            f"catalog dataset {dataset_name!r} is not ported yet (ROADMAP.md queue 1 item 1); "
            "use dataset_path (a saved dataset directory) or dataset: synthetic")

    raise ValueError(
        "No dataset configured: set data.dataset (synthetic) or data.dataset_path "
        "(saved dataset directory)."
    )
