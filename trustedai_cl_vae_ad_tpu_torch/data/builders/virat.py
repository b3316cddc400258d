"""VIRAT surveillance videos and their annotations into frame records, and
frames into a saved dataset.

Counterpart of ``trustedai_cl_vae_ad_tpu/data/builders/virat.py``, writing
the same files:
  * ``load_meta_data``: each ``.mp4`` under ``<root>/videos_original`` with
    its ``<root>/annotations/<basename>.viratdata.{events,mapping,objects}.txt``
    (a missing file is None, with a note on the console);
  * the three whitespace-separated annotation schemas (events: 10 columns,
    mapping: 6 + N, objects: 8);
  * ``parse_video_name_data``: group, scene and sequence (and segment, start
    and end seconds where present) from the ``VIRAT_S_GGSSQQ[_seg_start_end]``
    file name;
  * ``frame_records``: one record a video frame with the video's name data
    and that frame's events and objects (no pixels);
  * ``create_dataset``: the records as JSONL shards with an ``index.json``
    (format ``virat-jsonl-v1``), read back by ``ViratFrameDataset``;
  * ``extract_frames``: every ``frame_stride``-th frame decoded with cv2 into
    a saved dataset under ``<output>/train`` (``data/saved_dataset.py``), each
    frame brought to the first video's size, file paths ``<basename>#<frame>``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Iterator, Optional

import numpy as np

from trustedai_cl_vae_ad_tpu_torch.data.saved_dataset import save_dataset


def load_meta_data(virat_directory: str) -> dict:
    if not os.path.isdir(virat_directory):
        raise FileNotFoundError(f"VIRAT root not found: {virat_directory}")
    virat_directory = os.path.abspath(virat_directory)

    annotations_dir = os.path.join(virat_directory, "annotations")
    videos_dir = os.path.join(virat_directory, "videos_original")
    for d in (annotations_dir, videos_dir):
        if not os.path.isdir(d):
            raise FileNotFoundError(f"VIRAT directory not found: {d}")

    meta = {}
    for dirpath, _dirnames, filenames in os.walk(videos_dir):
        for filename in sorted(filenames):
            basename, ext = os.path.splitext(filename)
            if ext.lower() != ".mp4":
                continue
            paths = {}
            for kind in ("events", "mapping", "objects"):
                p = os.path.join(annotations_dir, f"{basename}.viratdata.{kind}.txt")
                if not os.path.isfile(p):
                    print(f"No {kind.capitalize()} File: {basename}")
                    p = None
                paths[f"{kind}_path"] = p
            meta[basename] = {"video_path": os.path.join(dirpath, filename), **paths}
    return meta


_EVENT_FIELDS = (
    "event_id", "event_type", "duration", "start_frame", "end_frame",
    "current_frame", "bbox_lefttop_x", "bbox_lefttop_y", "bbox_width", "bbox_height",
)
_OBJECT_FIELDS = (
    "obj_id", "duration", "current_frame", "bbox_lefttop_x", "bbox_lefttop_y",
    "bbox_width", "bbox_height", "obj_type",
)


def _parse_rows(path: Optional[str], fields: tuple) -> Optional[list]:
    if path is None or not os.path.isfile(path):
        return None
    out = []
    with open(path, "r") as ifile:
        for row in ifile:
            s = row.split()
            if not s:
                continue
            out.append({k: int(v) for k, v in zip(fields, s)})
    return out


def get_event_annotations_from_file(path):
    return _parse_rows(path, _EVENT_FIELDS)


def get_object_annotations_from_file(path):
    return _parse_rows(path, _OBJECT_FIELDS)


def get_mapping_annotations_from_file(path: Optional[str]) -> Optional[list]:
    if path is None or not os.path.isfile(path):
        return None
    out = []
    with open(path, "r") as ifile:
        for row in ifile:
            s = row.split()
            if not s:
                continue
            out.append(
                {
                    "event_id": int(s[0]),
                    "event_type": int(s[1]),
                    "duration": int(s[2]),
                    "start_frame": int(s[3]),
                    "end_frame": int(s[4]),
                    "num_objects": int(s[5]),
                    "obj_col_map": [int(i) for i in s[6:]],
                }
            )
    return out


def parse_annotations(meta_data: dict) -> dict:
    return {
        basename: {
            "events": get_event_annotations_from_file(obj["events_path"]),
            "mapping": get_mapping_annotations_from_file(obj["mapping_path"]),
            "objects": get_object_annotations_from_file(obj["objects_path"]),
        }
        for basename, obj in meta_data.items()
    }


def parse_video_name_data(basename: str) -> dict:
    seg = basename.split("_")
    out = {
        "basename": basename,
        "group_id": None,
        "scene_id": None,
        "sequence_id": None,
        "segment_id": None,
        "start_seconds": None,
        "end_seconds": None,
    }
    if len(seg) >= 3:
        code = seg[2]
        out["group_id"] = int(code[0:2])
        out["scene_id"] = int(code[2:4])
        out["sequence_id"] = int(code[4:6])
    if len(seg) >= 6:  # the baseline scenes carry no segment fields
        out["segment_id"] = int(seg[3])
        out["start_seconds"] = int(seg[4])
        out["end_seconds"] = int(seg[5])
    return out


def build_event_frame_map(annotations_entry: dict) -> dict:
    m = defaultdict(list)
    for idx, e in enumerate(annotations_entry.get("events") or []):
        m[e["current_frame"]].append(idx)
    return m


def build_object_frame_map(annotations_entry: dict) -> dict:
    m = defaultdict(list)
    for idx, o in enumerate(annotations_entry.get("objects") or []):
        m[o["current_frame"]].append(idx)
    return m


def frame_records(basename: str, meta_data: dict, annotations: dict) -> Iterator[dict]:
    """One annotation record a video frame (no pixels)."""
    entry = meta_data[basename]
    ann = annotations[basename]
    video_path = entry.get("video_path")
    if video_path is None or not os.path.isfile(video_path):
        return

    name_data = parse_video_name_data(basename)
    event_map = build_event_frame_map(ann)
    obj_map = build_object_frame_map(ann)

    total = _count_video_frames(video_path)
    for frame_id in range(total):
        yield {
            **name_data,
            "frame_id": frame_id,
            "events": [ann["events"][i] for i in event_map.get(frame_id, [])],
            "objects": [ann["objects"][i] for i in obj_map.get(frame_id, [])],
        }


def _count_video_frames(video_path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        print(f"Failed to open video: {video_path}")
        return 0
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return max(n, 0)


def create_dataset(meta_data: dict, output_path: str, shard_size: int = 50000) -> dict:
    """Write every video's frame records as JSONL shards and an index."""
    annotations = parse_annotations(meta_data)
    os.makedirs(output_path, exist_ok=True)
    shards = []
    count = 0
    shard_rows: list = []

    def flush():
        nonlocal shard_rows
        if not shard_rows:
            return
        name = f"frames_{len(shards):05d}.jsonl"
        with open(os.path.join(output_path, name), "w") as f:
            for r in shard_rows:
                f.write(json.dumps(r) + "\n")
        shards.append({"file": name, "num_items": len(shard_rows)})
        shard_rows = []

    for basename in meta_data:
        for rec in frame_records(basename, meta_data, annotations):
            shard_rows.append(rec)
            count += 1
            if len(shard_rows) >= shard_size:
                flush()
    flush()
    index = {"num_items": count, "shards": shards, "format": "virat-jsonl-v1"}
    with open(os.path.join(output_path, "index.json"), "w") as f:
        json.dump(index, f, indent=1)
    return index


def extract_frames(
    meta_data: dict,
    output_path: str,
    frame_stride: int = 30,
    max_frames_per_video: Optional[int] = None,
    batch_size: int = 32,
) -> dict:
    """Every ``frame_stride``-th frame of each video (at most
    ``max_frames_per_video`` a video) as a saved dataset in
    ``<output_path>/train``; returns its index."""
    import cv2

    def batches():
        # a saved dataset is uniform (its shards concatenate), and VIRAT mixes
        # 1080p, 720p and 480p: every frame takes the first video's size
        target_hw = None
        buf_imgs, buf_paths = [], []
        for basename, entry in meta_data.items():
            video_path = entry.get("video_path")
            if video_path is None or not os.path.isfile(video_path):
                continue
            cap = cv2.VideoCapture(video_path)
            if not cap.isOpened():
                print(f"Failed to open video: {video_path}")
                continue
            frame_id = 0
            taken = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if frame_id % frame_stride == 0:
                    rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                    if target_hw is None:
                        target_hw = rgb.shape[:2]
                    elif rgb.shape[:2] != target_hw:
                        h, w = target_hw
                        rgb = cv2.resize(rgb, (w, h), interpolation=cv2.INTER_AREA)
                    buf_imgs.append(rgb)
                    buf_paths.append(f"{basename}#{frame_id}")
                    taken += 1
                    if len(buf_imgs) >= batch_size:
                        yield {"image": np.stack(buf_imgs), "filepath": buf_paths}
                        buf_imgs, buf_paths = [], []
                    if max_frames_per_video and taken >= max_frames_per_video:
                        break
                frame_id += 1
            cap.release()
        if buf_imgs:
            yield {"image": np.stack(buf_imgs), "filepath": buf_paths}

    return save_dataset(os.path.join(output_path, "train"), batches())


class ViratFrameDataset:
    """The frame records of a built VIRAT dataset, streamed shard by shard."""

    def __init__(self, path: str):
        with open(os.path.join(path, "index.json")) as f:
            self.index = json.load(f)
        self.path = path

    def __len__(self):
        return self.index["num_items"]

    def __iter__(self) -> Iterator[dict]:
        for shard in self.index["shards"]:
            with open(os.path.join(self.path, shard["file"])) as f:
                for line in f:
                    yield json.loads(line)
