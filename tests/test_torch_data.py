"""The port's data modules against the JAX package's: the synthetic
generator's bytes, the saved-dataset format both ways, and the device
prefetch against the JAX ``preprocess_batch`` (atol 1e-5, the tolerance at
which tests/test_torch_resize.py pins the antialias resize)."""

import numpy as np
import pytest
import torch

from trustedai_cl_vae_ad_tpu.data import ingest as jingest
from trustedai_cl_vae_ad_tpu.data import loader as jloader
from trustedai_cl_vae_ad_tpu.data import saved_dataset as jsaved
from trustedai_cl_vae_ad_tpu_torch.data import ingest, loader, saved_dataset


def test_synthetic_dataset_yields_the_same_bytes():
    ours = list(loader.SyntheticDataset(10, [8, 12, 3], 4, seed=3))
    theirs = list(jloader.SyntheticDataset(10, [8, 12, 3], 4, seed=3))
    assert len(ours) == len(theirs) == len(loader.SyntheticDataset(10, [8, 12, 3], 4)) == 3
    for a, b in zip(ours, theirs):
        assert a["image"].dtype == np.uint8 and np.array_equal(a["image"], b["image"])
        assert a["filepath"] == b["filepath"]
    assert [x.shape[0] for x in loader.iter_images(ours)] == [4, 4, 2]
    assert [x.shape[0] for x in loader.iter_images([(b["image"], 0) for b in ours])] == [4, 4, 2]
    assert [x.shape[0] for x in loader.iter_images([b["image"] for b in ours])] == [4, 4, 2]


@pytest.mark.parametrize("writer, reader", [(saved_dataset, jsaved), (jsaved, saved_dataset),
                                            (saved_dataset, saved_dataset)],
                         ids=["port-writes", "jax-writes", "round-trip"])
def test_saved_dataset_is_one_format(tmp_path, writer, reader):
    batches = list(loader.SyntheticDataset(23, [6, 10, 3], 5, seed=1))
    index = writer.save_dataset(str(tmp_path), batches, shard_size=8)
    assert index["num_items"] == 23 and reader.is_saved_dataset(str(tmp_path))
    ds = reader.SavedDataset(str(tmp_path), batch_size=7)
    assert len(ds) == 4 and ds.num_items == 23
    got = list(ds)
    ref = list(jsaved.SavedDataset(str(tmp_path), batch_size=7))
    whole = np.concatenate([b["image"] for b in batches])
    assert np.array_equal(np.concatenate([b["image"] for b in got]), whole)
    for a, b in zip(got, ref):
        assert np.array_equal(a["image"], b["image"]) and a["filepath"] == b["filepath"]
    # the same seeded shuffle in both packages
    a = list(reader.SavedDataset(str(tmp_path), 7, shuffle=True, seed=5))
    b = list(jsaved.SavedDataset(str(tmp_path), 7, shuffle=True, seed=5))
    assert all(np.array_equal(x["image"], y["image"]) for x, y in zip(a, b))
    assert not np.array_equal(np.concatenate([x["image"] for x in a]), whole)


def test_saved_dataset_rescales_float_batches_and_rejects_other_directories(tmp_path):
    x = np.random.RandomState(0).uniform(0, 1, (3, 4, 4, 3)).astype(np.float32)
    saved_dataset.save_dataset(str(tmp_path / "f"), [x])
    (batch,) = list(saved_dataset.SavedDataset(str(tmp_path / "f"), 8))
    assert np.array_equal(batch["image"], np.round(x * 255).astype(np.uint8))
    with pytest.raises(FileNotFoundError):
        saved_dataset.SavedDataset(str(tmp_path), 8)


def test_device_prefetch_matches_jax_preprocess_and_keeps_order():
    source = list(loader.SyntheticDataset(10, [40, 64, 3], 4, seed=2))
    image_size = [32, 48, 3]
    got = list(ingest.device_prefetch(iter(source), image_size, "cpu", depth=2))
    assert len(got) == 3
    for out, batch in zip(got, source):
        assert out["filepath"] == batch["filepath"]
        assert out["image"].dtype == torch.float32 and out["image"].shape[1:] == (32, 48, 3)
        ref = np.asarray(jingest.preprocess_batch(batch["image"], image_size))
        np.testing.assert_allclose(out["image"].numpy(), ref, atol=1e-5, rtol=0)
    # float batches are taken as already normalized; bare arrays are batches too
    f = (source[0]["image"].astype(np.float32) / 255.0)
    (only,) = list(ingest.device_prefetch(iter([f]), image_size, "cpu"))
    np.testing.assert_allclose(only["image"].numpy(), got[0]["image"].numpy(), atol=1e-6)
    assert "filepath" not in only


def test_device_prefetch_hands_errors_on_and_stops_when_abandoned():
    def broken():
        yield {"image": np.zeros((2, 8, 8, 3), np.uint8)}
        raise OSError("corrupt frame")

    it = ingest.device_prefetch(broken(), [8, 8, 3], "cpu")
    next(it)
    with pytest.raises(OSError, match="corrupt frame"):
        next(it)

    made = []

    def endless():
        while True:
            made.append(1)
            yield {"image": np.zeros((1, 8, 8, 3), np.uint8)}

    it = ingest.device_prefetch(endless(), [8, 8, 3], "cpu", depth=2)
    next(it)
    it.close()  # joins the producer: nothing is made afterwards
    n = len(made)
    assert n <= 5
    import time
    time.sleep(0.3)
    assert len(made) == n


def test_load_data_sources(tmp_path):
    cfg = {"data": {"image_size": [8, 12, 3], "dataset": "synthetic", "n_train": 6, "n_val": 2},
           "training": {"batch_size": 4}}
    data = loader.load_data(cfg, device="cpu")
    shapes = [tuple(b["image"].shape) for b in data["train"]]
    assert shapes == [(4, 8, 12, 3), (2, 8, 12, 3)] and len(data["val"]) == 1
    assert [tuple(b["image"].shape) for b in data["train"]] == shapes  # re-iterable
    cfg["data"]["synthetic_frame_size"] = [10, 16]
    resized = next(iter(loader.load_data(cfg, device="cpu")["train"]))["image"]
    assert tuple(resized.shape) == (4, 8, 12, 3)

    batches = list(loader.SyntheticDataset(6, [8, 12, 3], 4, seed=0))
    saved_dataset.save_dataset(str(tmp_path / "ds" / "train"), batches)
    saved_dataset.save_dataset(str(tmp_path / "ds" / "validation"), batches[:1])
    cfg = {"data": {"image_size": [8, 12, 3], "dataset_path": str(tmp_path / "ds")},
           "training": {"batch_size": 4}}
    data = loader.load_data(cfg, device="cpu")
    first = next(iter(data["train"]))["image"]
    np.testing.assert_allclose(first.numpy(), batches[0]["image"] / np.float32(255.0), atol=1e-7)
    assert len(data["val"]) == 1
    single = {"data": {"image_size": [8, 12, 3], "dataset_path": str(tmp_path / "ds" / "train")},
              "training": {"batch_size": 4}}
    assert loader.load_data(single, device="cpu")["val"] is None

    for bad, error in (({"dataset": "raite"}, ValueError),  # a RAITE root is required
                       ({"dataset": "imagenet2012"}, NotImplementedError),
                       ({"dataset_path": str(tmp_path / "none")}, FileNotFoundError),
                       ({}, ValueError)):
        with pytest.raises(error):
            loader.load_data({"data": {"image_size": [8, 12, 3], **bad},
                              "training": {"batch_size": 4}}, device="cpu")


@pytest.mark.parametrize("kind", ["uint8-array", "uint8-tensor", "float-array"])
def test_host_images_normalizes_raw_pixels_only(kind):
    """uint8 frames come back as float32 in [0, 1]; float frames as they are."""
    raw = np.random.RandomState(3).randint(0, 256, (2, 4, 5, 3), dtype=np.uint8)
    given = {"uint8-array": raw, "uint8-tensor": torch.from_numpy(raw),
             "float-array": raw / 255.0}[kind]
    got = loader.host_images(given)
    assert isinstance(got, np.ndarray) and got.shape == raw.shape
    if kind == "float-array":
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, given)
    else:
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, raw.astype(np.float32) / 255.0)
