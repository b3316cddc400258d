"""RAITE event captures into per-match datasets.

Counterpart of ``trustedai_cl_vae_ad_tpu/data/builders/fix_raite.py``:
  * ``get_event_files``: the timestamped frames (``YYYYMMDD-HHMMSS-ffffff.png``)
    under a root;
  * ``split_by_match``: grouped by the (``camera-N``, ``still`` | ``match_N``)
    components of their paths;
  * ``combine_and_fix``: each frame read with cv2, its channels swapped
    (BGR <-> RGB) and written to ``<out>/<camera>/<match>/frames/`` on a
    thread pool (cv2 releases the interpreter lock), then a ``labels.json``
    for each group (``raite_json.py``). The originals are read, never moved.
    An unreadable frame is skipped with a warning;
  * ``output_match_annotations``: ``original_map.csv``, one row (original,
    new path) a written frame; a skipped frame has no row.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from trustedai_cl_vae_ad_tpu_torch.data.builders.raite_json import build_config_from_directory

FRAME_PATTERN = re.compile(r"^(?:\d{8})-(?:\d{6})-(?:\d{6})\.png$")
CAMERA_PATTERN = re.compile(r"camera-\d+")
MATCH_PATTERN = re.compile(r"still|match_\d+")


def get_event_files(root_dir: str) -> List[str]:
    if not os.path.isdir(root_dir):
        raise FileNotFoundError(f"event capture root not found: {root_dir}")
    out = []
    for root, _dirs, filenames in os.walk(root_dir):
        for f in sorted(filenames):
            if FRAME_PATTERN.match(f):
                out.append(os.path.join(root, f))
    return out


def split_by_match(png_files: List[str]) -> Dict[Tuple[str, str], List[str]]:
    match_dict: Dict[Tuple[str, str], List[str]] = defaultdict(list)
    for path in png_files:
        parts = os.path.normpath(path).split(os.sep)
        camera_name = next((el for el in parts if CAMERA_PATTERN.match(el)), None)
        if camera_name is None:
            continue
        event_name = next((el for el in parts if MATCH_PATTERN.match(el)), None)
        if event_name:
            match_dict[(camera_name, event_name)].append(path)
    return match_dict


def _bgr2rgb_move(camera_name: str, match_name: str, img_filepath: str,
                  output_dir: str) -> Optional[str]:
    """The written path, or None for an unreadable source (a row for a frame
    that was never written would name a file that does not exist)."""
    import cv2

    basename = os.path.basename(img_filepath)
    output_path = os.path.join(output_dir, camera_name, match_name, "frames", basename)
    if os.path.exists(output_path):
        return output_path
    img = cv2.imread(img_filepath)
    if img is None:
        print(f"WARNING: unreadable frame skipped: {img_filepath}")
        return None
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    cv2.imwrite(output_path, img)
    return output_path


def combine_and_fix(
    match_dict: Dict[Tuple[str, str], List[str]], output_dir: str, num_workers: int = 8
) -> Dict[Tuple[str, str], List[Optional[str]]]:
    if not match_dict:
        raise ValueError("no event frames to reorganize")
    if not os.path.isdir(output_dir):
        raise FileNotFoundError(f"output directory not found: {output_dir}")

    jobs = []
    for (camera_name, match_name), path_list in match_dict.items():
        os.makedirs(os.path.join(output_dir, camera_name, match_name, "frames"), exist_ok=True)
        for path in path_list:
            jobs.append((camera_name, match_name, path))

    new_match_dict: Dict[Tuple[str, str], List[Optional[str]]] = defaultdict(list)
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = [pool.submit(_bgr2rgb_move, c, m, p, output_dir) for c, m, p in jobs]
        for (c, m, _p), fut in zip(jobs, futures):
            new_match_dict[(c, m)].append(fut.result())

    for camera_name, match_name in match_dict.keys():
        img_dir = os.path.join(output_dir, camera_name, match_name, "frames")
        label_path = os.path.join(output_dir, camera_name, match_name, "labels.json")
        build_config_from_directory(img_dir, label_path, force_flag=True)

    return new_match_dict


def output_match_annotations(old_match_dict: dict, new_match_dict: dict, output_dir: str) -> None:
    with open(os.path.join(output_dir, "original_map.csv"), "w", newline="") as ofile:
        writer = csv.writer(ofile)
        writer.writerow(["original_path", "new_path"])
        for k, orig_list in old_match_dict.items():
            new_list = new_match_dict.get(k)
            if not new_list:
                continue
            for orig_path, new_path in zip(orig_list, new_list):
                if new_path is not None:  # None: an unreadable source, skipped
                    writer.writerow([orig_path, new_path])


def fix_raite_event_data(root_dir: str, output_dir: str, num_workers: int = 8) -> None:
    png_files = get_event_files(root_dir)
    match_dict = split_by_match(png_files)
    new_match_dict = combine_and_fix(match_dict, output_dir, num_workers)
    output_match_annotations(match_dict, new_match_dict, output_dir)
