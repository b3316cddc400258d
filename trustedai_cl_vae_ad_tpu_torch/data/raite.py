"""The RAITE COCO-JSON dataset: the index and its parallel-decode batch streams.

Counterpart of ``trustedai_cl_vae_ad_tpu/data/raite.py``: a train and a test
``labels.json`` (``data/coco.py``: images in a ``frames/`` directory beside
each), batch streams of {'image': uint8 (B, H, W, C), 'filepath': [str]}
decoded on a thread pool (``data/pipeline.py``), 32 frames a batch by
default; split helpers that yield the images or the file paths alone;
``cache()`` keeps the decoded batches in host memory after the first pass.
Normalizing and resizing run on the device (``data/ingest.py``).

``python -m trustedai_cl_vae_ad_tpu_torch.data.raite TRAIN_JSON TEST_JSON
[-e EPOCHS]`` walks both streams and prints the host decode rate.
"""

from __future__ import annotations

import time
from typing import Iterator

from trustedai_cl_vae_ad_tpu_torch.data.coco import load_coco_index
from trustedai_cl_vae_ad_tpu_torch.data.pipeline import (
    CachedDataset,
    MappedDataset,
    ParallelDecodeIterable,
    batched,
)


class _Stream:
    """Re-iterable batches of a list of image files, decoded in parallel."""

    def __init__(self, paths, batchsize: int, num_workers: int):
        self.paths = paths
        self.batchsize = batchsize
        self.num_workers = num_workers

    def __iter__(self) -> Iterator[dict]:
        return batched(ParallelDecodeIterable(self.paths, num_workers=self.num_workers),
                       self.batchsize)

    def __len__(self):
        return (len(self.paths) + self.batchsize - 1) // self.batchsize


class RaiteDataset:
    def __init__(self, train_json_path: str, test_json_path: str, batchsize: int = 32,
                 num_workers: int = 8):
        self.train_dict = load_coco_index(train_json_path)
        self.test_dict = load_coco_index(test_json_path)
        self.batchsize = batchsize
        self.num_workers = num_workers
        self.train_data = _Stream(self.filepaths("train"), batchsize, num_workers)
        self.test_data = _Stream(self.filepaths("test"), batchsize, num_workers)

    def filepaths(self, dataset_selection: str) -> list:
        if dataset_selection not in ("train", "test"):
            raise RuntimeError(
                f'Error, unrecognized argument: {dataset_selection} (["test", "train"])')
        data_dict = self.train_dict if dataset_selection == "train" else self.test_dict
        return [row["full_filepath"] for row in data_dict["images"]]

    def split_train_data_labels(self):
        return (MappedDataset(self.train_data, lambda b: b["image"]),
                MappedDataset(self.train_data, lambda b: b["filepath"]))

    def split_test_data_labels(self):
        return (MappedDataset(self.test_data, lambda b: b["image"]),
                MappedDataset(self.test_data, lambda b: b["filepath"]))

    def cache(self) -> None:
        """Keep the decoded batches in host memory after their first pass;
        ``len()`` stays O(1) (from the path lists)."""
        self.train_data = CachedDataset(lambda s=self.train_data: iter(s),
                                        sized_source=self.train_data)
        self.test_data = CachedDataset(lambda s=self.test_data: iter(s),
                                       sized_source=self.test_data)


def benchmark_epochs(dataset, num_epochs: int = 2) -> float:
    """Walk ``num_epochs`` epochs of ``dataset``; prints and returns the seconds."""
    start_time = time.perf_counter()
    n = 0
    for _ in range(num_epochs):
        for batch in dataset:
            img = batch["image"] if isinstance(batch, dict) else batch
            n += len(img)
    dt = time.perf_counter() - start_time
    print(f"Execution Time: {dt} ({n} frames, {n / dt:.1f} frames/s)")
    return dt


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("train_json_path", type=str, help="Train File Location")
    parser.add_argument("test_json_path", type=str, help="Test File Location")
    parser.add_argument("--benchmark-epochs", "-e", type=int, default=2,
                        help="Number of epochs to benchmark")
    args = parser.parse_args(argv)

    db = RaiteDataset(args.train_json_path, args.test_json_path)
    print("Training Set")
    benchmark_epochs(db.train_data, args.benchmark_epochs)
    print("Test Set")
    benchmark_epochs(db.test_data, args.benchmark_epochs)
    print("Benchmark complete")


if __name__ == "__main__":
    main()
