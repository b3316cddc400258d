"""The RAITE / COCO-JSON data path of the port against the JAX package's:
``data/coco.py``, ``data/raite.py``, the batching and caching half of
``data/pipeline.py``, ``data/ingest.py``'s device cache and ``load_data`` on
``configs/raite.yml``'s data block. Frames are PNGs written in ``tmp_path``
from numpy seeds. Tolerance: the frames are decoded by the same library and
not resized, so uint8 batches and file paths are equal; the normalized
float32 batches are within one float32 step (rtol 2e-7), since XLA on the
CPU takes x / 255 as a product with the reciprocal where PyTorch divides."""

import copy
import json
import os
import threading

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from trustedai_cl_vae_ad_tpu.data import coco as jcoco
from trustedai_cl_vae_ad_tpu.data import ingest as jingest
from trustedai_cl_vae_ad_tpu.data import pipeline as jpipeline
from trustedai_cl_vae_ad_tpu.data import raite as jraite
from trustedai_cl_vae_ad_tpu_torch.data import coco, ingest, pipeline, raite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_split(root, split, n, hw=(12, 16), seed=0, frames_dir="frames"):
    """``<root>/<split>/labels.json`` with n PNG frames in ``frames/`` beside
    it, one annotation on each even frame; returns the labels path."""
    rng = np.random.RandomState(seed)
    split_dir = os.path.join(root, split)
    os.makedirs(os.path.join(split_dir, frames_dir), exist_ok=True)
    data = coco.new_coco_skeleton(f"{split} fixture")
    data["categories"].append({"id": 1, "name": "anomaly"})
    for i in range(n):
        name = f"frame_{i:04d}.png"
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(split_dir, frames_dir, name))
        data["images"].append({"id": i, "file_name": name, "width": hw[1], "height": hw[0]})
        if i % 2 == 0:
            data["annotations"].append({"id": 100 + i, "image_id": i, "category_id": 1,
                                        "bbox": [1, 2, 3, 4], "area": 12, "iscrowd": 0})
    path = os.path.join(split_dir, "labels.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


@pytest.fixture
def splits(tmp_path):
    root = str(tmp_path / "raite")
    return root, write_split(root, "train", 7, seed=1), write_split(root, "test", 5, seed=2)


def assert_batches_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, dict):
            assert set(g) == set(r)
            assert g.get("filepath") == r.get("filepath")
            g, r = g["image"], r["image"]
        if isinstance(r, list):
            assert g == r
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape
        if r.dtype == np.float32:
            np.testing.assert_allclose(g, r, rtol=2e-7, atol=0)
        else:
            np.testing.assert_array_equal(g, r)


# -- data/coco.py --------------------------------------------------------------------------

def test_coco_index_matches_jax(splits):
    _, train_json, _ = splits
    got, ref = coco.load_coco_index(train_json), jcoco.load_coco_index(train_json)
    assert got == ref
    assert all(os.path.isfile(row["full_filepath"]) for row in got["images"])
    assert coco.image_annotation_map(got) == jcoco.image_annotation_map(ref)
    assert coco.new_coco_skeleton("x") == jcoco.new_coco_skeleton("x")
    coco.validate_coco_data(got)
    jcoco.validate_coco_data(ref)


def _break(data, how):
    data = copy.deepcopy(data)
    ann, image = data["annotations"][0], data["images"][0]
    if how == "missing_key":
        del data["info"]
    elif how == "image_key":
        del image["width"]
    elif how == "duplicate_image":
        data["images"].append(dict(image))
    elif how == "bad_size":
        image["height"] = 0
    elif how == "category_key":
        del data["categories"][0]["name"]
    elif how == "annotation_key":
        del ann["iscrowd"]
    elif how == "duplicate_annotation":
        data["annotations"].append(dict(ann))
    elif how == "unknown_image":
        ann["image_id"] = 999
    elif how == "unknown_category":
        ann["category_id"] = 7
    elif how == "bbox":
        ann["bbox"] = [1, 2, 3]
    elif how == "area":
        ann["area"] = 13
    elif how == "iscrowd":
        ann["iscrowd"] = 2
    return data


@pytest.mark.parametrize("how", ["missing_key", "image_key", "duplicate_image", "bad_size",
                                 "category_key", "annotation_key", "duplicate_annotation",
                                 "unknown_image", "unknown_category", "bbox", "area", "iscrowd"])
def test_validate_coco_data_refuses_what_jax_refuses(splits, how):
    data = _break(coco.load_coco_index(splits[1]), how)
    with pytest.raises(AssertionError):
        jcoco.validate_coco_data(data)
    with pytest.raises(ValueError):
        coco.validate_coco_data(data)


def test_coco_index_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        coco.load_coco_index(str(tmp_path / "none.json"))
    path = write_split(str(tmp_path), "a", 2)
    os.remove(os.path.join(tmp_path, "a", "frames", "frame_0001.png"))
    with pytest.raises(FileNotFoundError, match="frame_0001"):
        coco.load_coco_index(path)
    with pytest.raises(AssertionError):
        jcoco.load_coco_index(path)
    path = write_split(str(tmp_path), "b", 2, frames_dir="images")
    with pytest.raises(FileNotFoundError, match="frames"):
        coco.load_coco_index(path)


# -- data/raite.py --------------------------------------------------------------------------

def test_raite_dataset_matches_jax(splits, capsys):
    _, train_json, test_json = splits
    got = raite.RaiteDataset(train_json, test_json, batchsize=3, num_workers=2)
    ref = jraite.RaiteDataset(train_json, test_json, batchsize=3, num_workers=2)
    for split in ("train", "test"):
        assert got.filepaths(split) == ref.filepaths(split)
    assert len(got.train_data) == len(ref.train_data) == 3
    assert len(got.test_data) == len(ref.test_data) == 2
    assert_batches_equal(got.train_data, ref.train_data)
    assert_batches_equal(got.test_data, ref.test_data)
    for mine, theirs in zip(got.split_train_data_labels() + got.split_test_data_labels(),
                            ref.split_train_data_labels() + ref.split_test_data_labels()):
        assert_batches_equal(mine, theirs)
    with pytest.raises(RuntimeError):
        got.filepaths("validation")
    got.cache()
    ref.cache()
    assert len(got.train_data) == 3
    first = list(got.train_data)
    assert_batches_equal(first, ref.train_data)
    assert all(a is b for a, b in zip(list(got.train_data), first))  # replayed, not decoded
    assert raite.benchmark_epochs(got.test_data, 2) > 0
    raite.main([train_json, test_json, "-e", "1"])
    assert "Benchmark complete" in capsys.readouterr().out


# -- data/pipeline.py: batching and caching --------------------------------------------------

def _pairs(shapes):
    rng = np.random.RandomState(4)
    return [(rng.randint(0, 256, s, dtype=np.uint8), f"f{i}") for i, s in enumerate(shapes)]


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("shapes", [[(4, 5, 3)] * 7, [(4, 5, 3)] * 2 + [(6, 5, 3)] * 4,
                                    [(4, 5, 3)] * 3 + [(6, 5, 3)] + [(4, 5, 3)] * 2],
                         ids=["uniform", "ragged", "interleaved"])
def test_batched_matches_jax(shapes, drop_remainder):
    pairs = _pairs(shapes)
    assert_batches_equal(pipeline.batched(pairs, 3, drop_remainder),
                         jpipeline.batched(pairs, 3, drop_remainder))


def test_cached_dataset_and_mapped_dataset_match_jax():
    calls = {"port": 0, "jax": 0}

    def factory(tag):
        def make():
            calls[tag] += 1
            return iter([{"image": np.full((2, 2), i)} for i in range(4)])
        return make

    sized = list(range(4))
    got = pipeline.CachedDataset(factory("port"), sized_source=sized)
    ref = jpipeline.CachedDataset(factory("jax"), sized_source=sized)
    assert len(got) == len(ref) == 4 and calls == {"port": 0, "jax": 0}
    for _ in range(3):
        assert_batches_equal(got, ref)
    assert calls == {"port": 1, "jax": 1}
    unsized = pipeline.CachedDataset(factory("port"))
    assert len(unsized) == 4 and calls["port"] == 2
    mapped = pipeline.MappedDataset(got, lambda b: b["image"] * 2)
    assert len(mapped) == 4
    assert_batches_equal(mapped, jpipeline.MappedDataset(ref, lambda b: b["image"] * 2))


def test_background_prefetcher_matches_jax_and_releases_its_thread():
    assert list(pipeline.BackgroundPrefetcher(range(20), depth=3)) == list(
        jpipeline.BackgroundPrefetcher(range(20), depth=3)) == list(range(20))

    def failing():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(pipeline.BackgroundPrefetcher(failing()))
    before = threading.active_count()
    it = iter(pipeline.BackgroundPrefetcher(iter(range(10 ** 6)), depth=2))
    assert next(it) == 0
    it.close()  # an abandoned iteration joins its producer
    assert threading.active_count() == before


# -- data/ingest.py: the device cache ----------------------------------------------------------

class CountingSource:
    """A re-iterable host source that counts its passes."""

    def __init__(self, n_batches=4, shape=(3, 6, 8, 3), seed=0):
        rng = np.random.RandomState(seed)
        self.batches = [{"image": rng.randint(0, 256, shape, dtype=np.uint8),
                         "filepath": [f"b{i}/{j}" for j in range(shape[0])]}
                        for i in range(n_batches)]
        self.passes = 0

    def __iter__(self):
        self.passes += 1
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _batch_bytes(source):
    return int(np.prod(source.batches[0]["image"].shape)) * 4  # float32 on the device


@pytest.mark.parametrize("fits", [True, False], ids=["cached", "over-budget"])
def test_device_cached_stream_matches_jax(fits):
    size = (6, 8, 3)
    src, jsrc = CountingSource(), CountingSource()
    limit = _batch_bytes(src) * (len(src) if fits else 2)
    logged = []
    got = ingest.DeviceCachedStream(src, size, "cpu", max_bytes=limit, log=logged.append)
    ref = jingest.DeviceCachedStream(jsrc, size, max_bytes=limit)
    for epoch in range(3):
        mine, theirs = list(got), list(ref)
        assert_batches_equal(mine, [{"image": np.asarray(b["image"]), "filepath": b["filepath"]}
                                    for b in theirs])
        if epoch == 0:
            first = mine
    assert got.cached == fits and (ref._cache is not None) == fits
    assert got._gave_up == ref._gave_up == (not fits)
    if fits:
        assert src.passes == 1  # epochs after the first never touch the host
        assert all(a["image"] is b["image"] for a, b in zip(list(got), first))
        assert got.nbytes == limit == got.budget.used
        assert not logged
    else:
        assert src.passes == jsrc.passes == 3
        assert got.nbytes == 0 and got.budget.used == 0
        assert len(logged) == 1 and "device-cache budget" in logged[0]


def test_device_cache_budget_is_shared_and_an_abandoned_fill_returns_it():
    a, b = CountingSource(seed=1), CountingSource(seed=2)
    budget = ingest.DeviceCacheBudget(_batch_bytes(a) * 6)
    first = ingest.DeviceCachedStream(a, (6, 8, 3), "cpu", budget=budget, log=lambda m: None)
    second = ingest.DeviceCachedStream(b, (6, 8, 3), "cpu", budget=budget, log=lambda m: None)
    list(first)
    assert first.cached and budget.used == _batch_bytes(a) * 4
    it = iter(second)
    next(it)
    it.close()  # abandoned mid-epoch: its reservation goes back
    assert budget.used == _batch_bytes(a) * 4 and not second.cached
    list(second)  # 4 more batches pass the 6 the budget holds
    assert second._gave_up and not second.cached and budget.used == _batch_bytes(a) * 4


# -- data/loader.py ----------------------------------------------------------------------------

@pytest.mark.parametrize("device_cache", [False, True], ids=["host", "device-cache"])
def test_load_data_on_the_raite_config_matches_jax(tmp_path, device_cache):
    from trustedai_cl_vae_ad_tpu.data.loader import load_data as jax_load_data
    from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data

    with open(os.path.join(REPO, "configs", "raite.yml")) as f:
        config = yaml.safe_load(f)
    root = str(tmp_path / "raite")
    hw = tuple(config["data"]["image_size"][:2])  # frames at the model's size: no resize
    write_split(root, config["data"]["train_split"], 5, hw=hw, seed=3)
    write_split(root, config["data"]["val_split"], 3, hw=hw, seed=4)
    config["data"]["dataset_path"] = root
    config["training"]["batch_size"] = 2
    if device_cache:
        config["data"]["device_cache"] = True
    got, ref = load_data(config, device="cpu"), jax_load_data(copy.deepcopy(config))
    assert set(got) == set(ref)
    for split in ("train", "val"):
        assert len(got[split]) == len(ref[split]) == {"train": 3, "val": 2}[split]
        for _ in range(2):
            assert_batches_equal(got[split], ref[split])
            assert_batches_equal(got[f"{split}_labels"], ref[f"{split}_labels"])
        mine = next(iter(got[split]))
        assert mine.dtype == torch.float32 and tuple(mine.shape[1:]) == (*hw, 3)
    stream = got["train_full"]
    assert isinstance(stream, ingest.DeviceCachedStream) == device_cache
    if device_cache:
        assert stream.cached and not isinstance(got["raite_db"].train_data,
                                                pipeline.CachedDataset)
    else:
        assert isinstance(got["raite_db"].train_data, pipeline.CachedDataset)
    config["data"]["val_split"] = "missing"
    with pytest.raises(FileNotFoundError, match="missing"):
        load_data(config, device="cpu")
