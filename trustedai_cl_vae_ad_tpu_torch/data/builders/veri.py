"""VeRi vehicle crops: two image directories into a saved dataset.

Counterpart of ``trustedai_cl_vae_ad_tpu/data/builders/veri.py``: every image
under each directory (walked in sorted order), decoded by
``data/pipeline.py::decode_image_rgb`` (cv2, then PIL) on its thread pool,
resized on the host with PIL's bilinear filter to ``image_size`` (224x224 by
default) and batched, then written with ``data/saved_dataset.py::save_dataset``
as ``<output>/train`` and ``<output>/validation``, which ``data/loader.py``'s
``dataset_path`` branch reads. VeRi crops come in many sizes; resizing before
batching keeps the batches full (``batched`` ends a batch where the shape
changes).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from trustedai_cl_vae_ad_tpu_torch.data.pipeline import (
    ParallelDecodeIterable,
    batched,
    decode_image_rgb,
)
from trustedai_cl_vae_ad_tpu_torch.data.saved_dataset import save_dataset

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif")


def list_images(data_path: str) -> list:
    if not os.path.isdir(data_path):
        raise FileNotFoundError(f"image directory not found: {data_path}")
    out = []
    for root, _dirs, files in os.walk(data_path):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS:
                out.append(os.path.join(root, f))
    return out


def resized_batches(data_path: str, image_size=(224, 224), batch_size: int = 32) -> Iterator[dict]:
    """{'image': uint8 (B, H, W, 3), 'filepath': [str]} batches of the
    directory's images, each decoded and resized in the worker pool; an
    unreadable file is skipped."""
    h, w = int(image_size[0]), int(image_size[1])

    def decode_resized(path):
        img = decode_image_rgb(path)
        if img is None:
            return None
        if img.shape[:2] != (h, w):
            from PIL import Image

            img = np.asarray(
                Image.fromarray(img).resize((w, h), Image.BILINEAR), np.uint8
            )
        return img

    source = ParallelDecodeIterable(list_images(data_path), decode_fn=decode_resized)
    yield from batched(source, batch_size)


def build_veri_dataset(
    train_path: str, val_path: str, output_path: str, image_size=(224, 224), batch_size: int = 32
) -> None:
    os.makedirs(output_path)
    save_dataset(
        os.path.join(output_path, "train"), resized_batches(train_path, image_size, batch_size)
    )
    save_dataset(
        os.path.join(output_path, "validation"), resized_batches(val_path, image_size, batch_size)
    )
