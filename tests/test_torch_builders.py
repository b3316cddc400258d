"""The port's dataset builders (``trustedai_cl_vae_ad_tpu_torch/data/builders``)
and their ``*_torch.py`` CLIs against the JAX package's builders, on the same
inputs written in ``tmp_path``: a RAITE raw dump, VeRi-layout crops and a
VIRAT root with two short videos. Each pair of outputs must be equal (saved
arrays byte for byte, the same file paths, the same JSON and CSV; the
``info.year`` of a ``labels.json`` set aside, as it is the day's year), and
each saved dataset must load through the port's ``load_data`` as through the
JAX package's."""

import copy
import csv
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import build_raite_json_from_directory_torch
import build_veri_dataset_torch
import build_virat_dataset_torch
import coco_validator_torch
import fix_raite_event_data_torch
from trustedai_cl_vae_ad_tpu.data.builders import fix_raite as jax_fix_raite
from trustedai_cl_vae_ad_tpu.data.builders import raite_json as jax_raite_json
from trustedai_cl_vae_ad_tpu.data.builders import veri as jax_veri
from trustedai_cl_vae_ad_tpu.data.builders import virat as jax_virat
from trustedai_cl_vae_ad_tpu.data.loader import load_data as jax_load_data
from trustedai_cl_vae_ad_tpu_torch.data import coco
from trustedai_cl_vae_ad_tpu_torch.data.builders import fix_raite, raite_json, veri, virat
from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data
from trustedai_cl_vae_ad_tpu_torch.data.saved_dataset import SavedDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(rs, h, w):
    return rs.randint(0, 256, (h, w, 3), dtype=np.uint8)


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _labels(path):
    """A labels.json with its ``info.year`` (the day's year) set aside."""
    with open(path) as f:
        data = json.load(f)
    year = data["info"].pop("year")
    assert isinstance(year, int)
    return data


def _saved_equal(got_dir, ref_dir):
    """Two saved datasets hold the same index and the same arrays, byte for
    byte, shard by shard."""
    with open(os.path.join(got_dir, "index.json")) as f, \
            open(os.path.join(ref_dir, "index.json")) as g:
        index = json.load(f)
        assert index == json.load(g)
    for shard in index["shards"]:
        with np.load(os.path.join(got_dir, shard["file"])) as a, \
                np.load(os.path.join(ref_dir, shard["file"])) as b:
            assert a["images"].dtype == b["images"].dtype == np.uint8
            assert a["images"].tobytes() == b["images"].tobytes()
            assert a["images"].shape == b["images"].shape
            assert a["filepaths"].tolist() == b["filepaths"].tolist()
    return index


def _batches_equal(got, ref, n):
    assert len(got) == len(ref) == n
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a["image"].numpy(), np.asarray(b["image"]), rtol=2e-7, atol=0)


# -- RAITE: labels.json from a directory, raw event captures --------------------------------

@pytest.fixture
def raite_dump(tmp_path):
    """A raw capture dump: timestamped PNGs under camera-N/match_N or still,
    one of them unreadable, and files that are not frames or not a camera's."""
    rs = np.random.RandomState(0)
    root = tmp_path / "raw" / "event_7"
    frames = {
        "camera-1/match_2": ["20230101-120000-000001.png", "20230101-120000-000002.png",
                             "20230101-120000-000004.png"],
        "camera-2/still": ["20230101-120001-000001.png"],
        "camera-2/match_10": ["20230101-120002-000001.png", "20230101-120002-000003.png"],
        "misc": ["20230101-120003-000001.png"],  # no camera in its path
    }
    for sub, names in frames.items():
        (root / sub).mkdir(parents=True)
        for name in names:
            Image.fromarray(_image(rs, 12, 16)).save(root / sub / name)
    (root / "camera-1" / "match_2" / "20230101-120000-000003.png").write_bytes(b"not a png")
    (root / "camera-1" / "notaframe.png").write_bytes(b"x")
    return str(tmp_path / "raw")


def test_fix_raite_writes_what_the_jax_builder_writes(raite_dump, tmp_path, capsys):
    before = _files(raite_dump)
    out = {}
    for name, module in (("jax", jax_fix_raite), ("port", fix_raite)):
        out[name] = str(tmp_path / f"out_{name}")
        os.makedirs(out[name])
        module.fix_raite_event_data(raite_dump, out[name], num_workers=3)
    # the captures are read, never moved or changed
    assert _files(raite_dump) == before
    got, ref = _files(out["port"]), _files(out["jax"])
    assert set(got) == set(ref)
    assert sorted(k for k in got if k.endswith("labels.json")) == [
        "camera-1/match_2/labels.json", "camera-2/match_10/labels.json",
        "camera-2/still/labels.json"]
    for rel in got:
        if rel.endswith("labels.json"):
            assert _labels(os.path.join(out["port"], rel)) == _labels(os.path.join(out["jax"], rel))
        elif rel != "original_map.csv":
            assert got[rel] == ref[rel], rel
    # the unreadable frame is skipped by both: no copy, no label, no map row
    assert "camera-1/match_2/frames/20230101-120000-000003.png" not in got
    assert len(_labels(os.path.join(out["port"], "camera-1/match_2/labels.json"))["images"]) == 3
    rows = {}
    for name in out:
        with open(os.path.join(out[name], "original_map.csv"), newline="") as f:
            rows[name] = [[r[0], os.path.relpath(r[1], out[name]) if i else r[1]]
                          for i, r in enumerate(csv.reader(f))]
    assert rows["port"] == rows["jax"]
    assert len(rows["port"]) == 1 + 6
    assert not any(r[0].endswith("120000-000003.png") for r in rows["port"])
    assert capsys.readouterr().out.count("unreadable frame skipped") == 2
    # the copy swapped the channels of each frame
    src = os.path.join(raite_dump, "event_7", "camera-2", "still", "20230101-120001-000001.png")
    dst = os.path.join(out["port"], "camera-2", "still", "frames", "20230101-120001-000001.png")
    np.testing.assert_array_equal(cv2.imread(dst), cv2.imread(src)[..., ::-1])


def test_fix_raite_groups(tmp_path):
    base = tmp_path / "camera-1" / "match_2"
    base.mkdir(parents=True)
    rng = np.random.RandomState(3)
    good = base / "20230101-120000-000001.png"
    Image.fromarray(_image(rng, 8, 8)).save(good)
    (base / "notaframe.png").write_bytes(b"x")
    files = fix_raite.get_event_files(str(tmp_path))
    assert files == [str(good)] == jax_fix_raite.get_event_files(str(tmp_path))
    groups = fix_raite.split_by_match(files)
    assert dict(groups) == dict(jax_fix_raite.split_by_match(files))
    assert ("camera-1", "match_2") in groups
    with pytest.raises(FileNotFoundError):
        fix_raite.get_event_files(str(tmp_path / "missing"))


@pytest.fixture
def raite_dir(tmp_path):
    """Tiny RAITE-style dataset: train/ + test/ with frames/ + labels.json."""
    rng = np.random.RandomState(0)
    for split, n in (("train", 7), ("test", 4)):
        frames = tmp_path / split / "frames"
        frames.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(_image(rng, 24, 32)).save(frames / f"frame_{i:03d}.png")
        raite_json.build_config_from_directory(str(frames), str(tmp_path / split / "labels.json"))
    return tmp_path


def test_coco_builder_and_validator(raite_dir):
    data = coco.load_coco_index(str(raite_dir / "train" / "labels.json"))
    coco.validate_coco_data(data)
    assert len(data["images"]) == 7
    assert all(os.path.exists(r["full_filepath"]) for r in data["images"])
    assert data["images"][0]["width"] == 32 and data["images"][0]["height"] == 24


def test_raite_json_builder_matches_jax_with_force_and_merge(raite_dir, tmp_path):
    frames = str(raite_dir / "train" / "frames")
    Image.fromarray(_image(np.random.RandomState(1), 10, 6)).save(
        os.path.join(frames, "extra.jpg"))
    out = {}
    for name, module in (("jax", jax_raite_json), ("port", raite_json)):
        path = out[name] = str(tmp_path / f"{name}.json")
        first = module.build_config_from_directory(frames, path)
        assert [im["file_name"] for im in first["images"]] == [
            f"frame_{i:03d}.png" for i in range(7)]
        with pytest.raises(SystemExit) as err:  # exists, neither force nor merge
            module.build_config_from_directory(frames, path)
        assert err.value.code == 1
        with pytest.raises(SystemExit):  # nothing to merge into
            module.build_config_from_directory(frames, path + ".none", merge_flag=True)
        with open(path) as f:
            data = json.load(f)
        data["categories"].append({"id": 3, "name": "car"})
        with open(path, "w") as f:
            json.dump(data, f)
        # merge keeps the other sections and rebuilds the images
        merged = module.build_config_from_directory(frames, path, merge_flag=True,
                                                    extensions=(".png", ".jpg"))
        assert merged["categories"] == [{"id": 3, "name": "car"}]
        assert len(merged["images"]) == 8
    assert _labels(out["port"]) == _labels(out["jax"])
    forced = raite_json.build_config_from_directory(frames, out["port"], force_flag=True)
    assert forced["categories"] == [] and len(forced["images"]) == 7


# -- VeRi: image directories into a saved dataset -------------------------------------------

@pytest.fixture
def veri_dirs(tmp_path):
    """VeRi-layout crops: JPEG and PNG files in several sizes (one already at
    the output size, one in a subdirectory) and an unreadable file."""
    rs = np.random.RandomState(0)
    sizes = [(30, 40), (50, 20), (24, 24), (33, 47), (61, 29)]
    out = {}
    for split, n in (("image_train", 11), ("image_test", 5)):
        d = tmp_path / "VeRi" / split
        (d / "sub").mkdir(parents=True)
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            ext = ".jpg" if i % 2 else ".png"
            where = d / "sub" if i == 3 else d
            Image.fromarray(_image(rs, h, w)).save(where / f"{i:04d}_c{i % 3:03d}{ext}",
                                                   **({"quality": 90} if ext == ".jpg" else {}))
        (d / "broken.jpg").write_bytes(b"\xff\xd8 not a jpeg")
        (d / "notes.txt").write_text("not an image")
        out[split] = str(d)
    return out


def test_veri_builder_writes_what_the_jax_builder_writes_and_loads_alike(veri_dirs, tmp_path):
    train, val = veri_dirs["image_train"], veri_dirs["image_test"]
    assert veri.list_images(train) == jax_veri.list_images(train)
    out = {}
    for name, module in (("jax", jax_veri), ("port", veri)):
        out[name] = str(tmp_path / f"veri_{name}")
        module.build_veri_dataset(train, val, out[name], image_size=(24, 24), batch_size=4)
    for split, n in (("train", 11), ("validation", 5)):
        index = _saved_equal(os.path.join(out["port"], split), os.path.join(out["jax"], split))
        assert index["num_items"] == n  # broken.jpg skipped by both
    with pytest.raises(FileExistsError):
        veri.build_veri_dataset(train, val, out["port"], image_size=(24, 24))
    config = {"data": {"dataset_path": out["port"], "image_size": [24, 24, 3]},
              "training": {"batch_size": 4}}
    got, ref = load_data(config, device="cpu"), jax_load_data(copy.deepcopy(config))
    _batches_equal(got["train"], ref["train"], 3)
    _batches_equal(got["val"], ref["val"], 2)


# -- VIRAT: videos and annotations into frame records and frames ----------------------------

VIDEOS = {"VIRAT_S_010204_05_000856_000890": ((48, 64), 9), "VIRAT_S_040103": ((36, 40), 5)}


@pytest.fixture
def virat_root(tmp_path):
    """Two short mp4v videos of different sizes; the first has the three
    annotation files, the second only its objects."""
    root = tmp_path / "virat"
    (root / "videos_original").mkdir(parents=True)
    (root / "annotations").mkdir()
    rs = np.random.RandomState(5)
    for name, ((h, w), n) in VIDEOS.items():
        writer = cv2.VideoWriter(str(root / "videos_original" / f"{name}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
        assert writer.isOpened()
        for i in range(n):
            # smooth frames, so the codec keeps them apart
            frame = np.full((h, w, 3), 20 * i, np.uint8)
            frame[: h // 2] += rs.randint(0, 30, (h // 2, w, 3)).astype(np.uint8)
            writer.write(frame)
        writer.release()
    first = root / "annotations" / "VIRAT_S_010204_05_000856_000890.viratdata"
    first.with_suffix(".viratdata.events.txt").write_text(
        "1 4 10 5 15 2 10 12 30 40\n1 4 10 5 15 3 11 12 30 40\n\n2 1 3 0 2 2 5 5 8 8\n")
    first.with_suffix(".viratdata.mapping.txt").write_text("1 4 10 5 15 2 1 0 1\n")
    first.with_suffix(".viratdata.objects.txt").write_text(
        "1 9 2 10 12 5 6 1\n2 9 3 1 1 4 4 2\n")
    (root / "annotations" / "VIRAT_S_040103.viratdata.objects.txt").write_text(
        "7 5 0 1 2 3 4 1\n")
    (root / "videos_original" / "readme.txt").write_text("not a video")
    return str(root)


def test_virat_builder_writes_what_the_jax_builder_writes_and_loads_alike(virat_root, tmp_path,
                                                                          capsys):
    meta = virat.load_meta_data(virat_root)
    assert meta == jax_virat.load_meta_data(virat_root)
    assert list(meta) == sorted(VIDEOS)
    assert meta["VIRAT_S_040103"]["events_path"] is None
    assert capsys.readouterr().out.count("No ") == 4  # two missing files, each package
    out = {}
    for name, module in (("jax", jax_virat), ("port", virat)):
        out[name] = str(tmp_path / f"virat_{name}")
        index = module.create_dataset(meta, out[name], shard_size=4)
        assert index["num_items"] == sum(n for _hw, n in VIDEOS.values())
        module.extract_frames(meta, out[name], frame_stride=2, batch_size=3)
    got, ref = _files(out["port"]), _files(out["jax"])
    assert set(got) == set(ref)
    for rel in got:
        if rel.endswith((".jsonl", "index.json")) and not rel.startswith("train"):
            assert got[rel] == ref[rel], rel
    records = list(virat.ViratFrameDataset(out["port"]))
    assert records == list(jax_virat.ViratFrameDataset(out["jax"]))
    assert len(records) == len(virat.ViratFrameDataset(out["port"])) == 14
    frame2 = records[2]
    assert frame2["frame_id"] == 2 and [e["event_id"] for e in frame2["events"]] == [1, 2]
    assert [o["obj_id"] for o in frame2["objects"]] == [1]
    index = _saved_equal(os.path.join(out["port"], "train"), os.path.join(out["jax"], "train"))
    assert index["num_items"] == 5 + 3  # frames 0, 2, 4, 6, 8 and 0, 2, 4
    paths = [p for b in SavedDataset(os.path.join(out["port"], "train"), 8) for p in b["filepath"]]
    assert paths[5] == "VIRAT_S_040103#0"
    config = {"data": {"dataset_path": out["port"], "image_size": [48, 64, 3]},
              "training": {"batch_size": 4}}
    got_data, ref_data = load_data(config, device="cpu"), jax_load_data(copy.deepcopy(config))
    assert got_data["val"] is None and ref_data["val"] is None
    _batches_equal(got_data["train"], ref_data["train"], 2)


def test_virat_annotation_parsing(tmp_path):
    events = tmp_path / "e.txt"
    events.write_text("1 4 10 5 15 7 100 120 30 40\n1 4 10 5 15 8 101 121 30 40\n")
    objs = tmp_path / "o.txt"
    objs.write_text("2 300 7 50 60 20 20 1\n")
    mapping = tmp_path / "m.txt"
    mapping.write_text("1 4 10 5 15 3 1 0 1\n")
    ev = virat.get_event_annotations_from_file(str(events))
    assert len(ev) == 2 and ev[0]["event_type"] == 4 and ev[0]["current_frame"] == 7
    ob = virat.get_object_annotations_from_file(str(objs))
    assert ob[0]["obj_type"] == 1 and ob[0]["current_frame"] == 7
    mp = virat.get_mapping_annotations_from_file(str(mapping))
    assert mp == jax_virat.get_mapping_annotations_from_file(str(mapping))
    assert mp[0]["num_objects"] == 3 and mp[0]["obj_col_map"] == [1, 0, 1]
    assert ev == jax_virat.get_event_annotations_from_file(str(events))
    assert virat.get_event_annotations_from_file(None) is None

    ann = {"events": ev, "mapping": None, "objects": ob}
    emap = virat.build_event_frame_map(ann)
    omap = virat.build_object_frame_map(ann)
    assert emap[7] == [0] and emap[8] == [1]
    assert omap[7] == [0]

    for name in ("VIRAT_S_010204_05_000856_000890", "VIRAT_S_010204"):
        assert virat.parse_video_name_data(name) == jax_virat.parse_video_name_data(name)
    name = virat.parse_video_name_data("VIRAT_S_010204_05_000856_000890")
    assert name["group_id"] == 1 and name["scene_id"] == 2 and name["sequence_id"] == 4
    assert name["segment_id"] == 5 and name["start_seconds"] == 856 and name["end_seconds"] == 890
    assert virat.parse_video_name_data("VIRAT_S_010204")["segment_id"] is None


def test_virat_frame_extraction(tmp_path):
    videos = tmp_path / "videos_original"
    (tmp_path / "annotations").mkdir()
    videos.mkdir()
    path = str(videos / "VIRAT_S_010203_01_000100_000200.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 24))
    rng = np.random.RandomState(0)
    for _ in range(12):
        writer.write(rng.randint(0, 255, (24, 32, 3), np.uint8))
    writer.release()

    meta = virat.load_meta_data(str(tmp_path))
    out = tmp_path / "built"
    index = virat.extract_frames(meta, str(out), frame_stride=4)
    assert index["num_items"] == 3  # frames 0, 4, 8
    batches = list(SavedDataset(str(out / "train"), batch_size=2))
    assert sum(b["image"].shape[0] for b in batches) == 3
    assert batches[0]["filepath"][0].startswith("VIRAT_S_010203_01_000100_000200#")
    assert batches[0]["image"].shape[1:] == (24, 32, 3)
    capped = virat.extract_frames(meta, str(tmp_path / "capped"), frame_stride=1,
                                  max_frames_per_video=5)
    assert capped["num_items"] == 5


# -- the CLIs -------------------------------------------------------------------------------

def test_builder_clis_match_the_jax_builders(raite_dump, veri_dirs, virat_root, tmp_path, capsys):
    # build_raite_json_from_directory_torch.py
    frames = os.path.join(raite_dump, "event_7", "camera-2", "match_10")
    labels = str(tmp_path / "labels.json")
    assert build_raite_json_from_directory_torch.main([frames, "-c", labels]) == 0
    jax_raite_json.build_config_from_directory(frames, str(tmp_path / "jax.json"))
    assert _labels(labels) == _labels(str(tmp_path / "jax.json"))
    with pytest.raises(SystemExit):
        build_raite_json_from_directory_torch.main([frames, "-c", labels])
    assert build_raite_json_from_directory_torch.main([frames, "-c", labels, "-f",
                                                       "-e", "jpg", ".png"]) == 0
    # coco_validator_torch.py
    capsys.readouterr()
    assert coco_validator_torch.main([labels]) == 0
    assert capsys.readouterr().out.strip() == f"OK: {labels} (2 images, 0 annotations)"
    bad = json.loads(open(labels).read())
    bad["annotations"].append({"id": 1, "image_id": 99, "category_id": 1, "bbox": [0, 0, 1, 1],
                               "area": 1, "iscrowd": 0})
    with open(tmp_path / "bad.json", "w") as f:
        json.dump(bad, f)
    with pytest.raises(ValueError, match="unknown image"):
        coco_validator_torch.main([str(tmp_path / "bad.json")])
    # fix_raite_event_data_torch.py: positional or -o; an existing output needs --force
    out = str(tmp_path / "fixed")
    assert fix_raite_event_data_torch.main([raite_dump, out]) == 0
    ref = str(tmp_path / "fixed_jax")
    os.makedirs(ref)
    jax_fix_raite.fix_raite_event_data(raite_dump, ref)
    assert set(_files(out)) == set(_files(ref))
    with pytest.raises(SystemExit) as err:
        fix_raite_event_data_torch.main([raite_dump, "-o", out])
    assert err.value.code == 1
    assert fix_raite_event_data_torch.main([raite_dump, "-o", out, "--force"]) == 0
    # build_veri_dataset_torch.py: 224x224 and batches of 32, as the JAX CLI
    veri_out = str(tmp_path / "veri")
    assert build_veri_dataset_torch.main([veri_dirs["image_train"], veri_dirs["image_test"],
                                          "-o", veri_out]) == 0
    jax_veri.build_veri_dataset(veri_dirs["image_train"], veri_dirs["image_test"],
                                str(tmp_path / "veri_jax"))
    for split in ("train", "validation"):
        index = _saved_equal(os.path.join(veri_out, split),
                             os.path.join(tmp_path, "veri_jax", split))
        with np.load(os.path.join(veri_out, split, index["shards"][0]["file"])) as f:
            assert f["images"].shape[1:] == (224, 224, 3)
    # build_virat_dataset_torch.py --extract-frames
    virat_out = str(tmp_path / "virat_out")
    assert build_virat_dataset_torch.main([virat_root, "-o", virat_out, "--extract-frames", "3",
                                           "--max-frames-per-video", "2", "-b", "3"]) == 0
    meta = jax_virat.load_meta_data(virat_root)
    jax_virat.create_dataset(meta, str(tmp_path / "virat_jax"))
    jax_virat.extract_frames(meta, str(tmp_path / "virat_jax"), frame_stride=3,
                             max_frames_per_video=2, batch_size=3)
    assert _saved_equal(os.path.join(virat_out, "train"),
                        os.path.join(tmp_path, "virat_jax", "train"))["num_items"] == 4
    assert _files(os.path.join(virat_out)).keys() == _files(str(tmp_path / "virat_jax")).keys()


def test_a_builder_cli_runs_as_a_script(raite_dir):
    """The scripts run from the repository root, with no device."""
    labels = str(raite_dir / "train" / "labels.json")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "coco_validator_torch.py"), labels],
                          capture_output=True, text=True, timeout=120, cwd=REPO,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"OK: {labels} (7 images, 0 annotations)"
