"""COCO-JSON index: parsing, path resolution and validation.

Counterpart of ``trustedai_cl_vae_ad_tpu/data/coco.py``: a ``labels.json``
whose images live in a ``frames/`` directory beside it, each row given its
``full_filepath``; the structural invariants of a COCO file (required keys,
bbox of length 4, area = w * h, iscrowd in {0, 1}, unique ids, annotations
that name an existing image and category); the empty skeleton the dataset
builders fill. The JAX package checks with ``assert``; here a missing file
raises ``FileNotFoundError`` and a broken structure ``ValueError``, so the
checks hold under ``python -O`` too.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise ValueError(message)


def load_coco_index(json_data_path: str) -> dict:
    """A COCO ``labels.json`` with each image row's ``full_filepath``
    resolved in the ``frames/`` directory beside it; a missing JSON, frames
    directory or image file raises ``FileNotFoundError``."""
    if not os.path.isfile(json_data_path):
        raise FileNotFoundError(f"COCO labels file not found: {json_data_path}")
    with open(json_data_path, "r") as ifile:
        data = json.load(ifile)
    _require(isinstance(data, dict), f"{json_data_path}: not a COCO JSON object")

    img_dirname = os.path.join(os.path.abspath(os.path.dirname(json_data_path)), "frames")
    if not os.path.isdir(img_dirname):
        raise FileNotFoundError(f"frames directory not found beside the labels: {img_dirname}")
    for row in data["images"]:
        image_filepath = os.path.join(img_dirname, row["file_name"])
        if not os.path.isfile(image_filepath):
            raise FileNotFoundError(f"image listed in {json_data_path} not found: "
                                    f"{image_filepath}")
        row["full_filepath"] = image_filepath
    return data


def image_annotation_map(data: dict) -> Dict[int, List[int]]:
    """image_id -> [indices of its annotations]."""
    out = defaultdict(list)
    for idx, annotation in enumerate(data.get("annotations", [])):
        out[annotation["image_id"]].append(idx)
    return out


def validate_coco_data(data: dict) -> None:
    """Raise ``ValueError`` at the first structural fault of a COCO dict."""
    for key in ("info", "categories", "images", "annotations"):
        _require(key in data, f"COCO data missing required key: {key}")

    image_ids = set()
    for image in data["images"]:
        for key in ("id", "file_name", "width", "height"):
            _require(key in image, f"COCO image missing key: {key}")
        _require(image["id"] not in image_ids, f"duplicate image id: {image['id']}")
        image_ids.add(image["id"])
        _require(image["width"] > 0 and image["height"] > 0,
                 f"image {image['id']}: width and height must be positive")

    category_ids = set()
    for category in data["categories"]:
        _require("id" in category and "name" in category, f"COCO category missing id or name: "
                 f"{category}")
        category_ids.add(category["id"])

    ann_ids = set()
    for ann in data["annotations"]:
        for key in ("id", "image_id", "category_id", "bbox", "area", "iscrowd"):
            _require(key in ann, f"COCO annotation missing key: {key}")
        _require(ann["id"] not in ann_ids, f"duplicate annotation id: {ann['id']}")
        ann_ids.add(ann["id"])
        _require(ann["image_id"] in image_ids,
                 f"annotation references unknown image {ann['image_id']}")
        _require(ann["category_id"] in category_ids,
                 f"annotation references unknown category {ann['category_id']}")
        bbox = ann["bbox"]
        _require(len(bbox) == 4, f"bbox must have length 4: {bbox}")
        w, h = bbox[2], bbox[3]
        _require(abs(ann["area"] - w * h) < 1e-6,
                 f"annotation {ann['id']}: area {ann['area']} != bbox w*h {w * h}")
        _require(ann["iscrowd"] in (0, 1), f"annotation {ann['id']}: iscrowd must be 0 or 1")


def new_coco_skeleton(description: str = "") -> dict:
    """Empty COCO structure for the dataset builders."""
    return {
        "info": {"description": description, "version": "1.0"},
        "licenses": [],
        "categories": [],
        "images": [],
        "annotations": [],
    }
