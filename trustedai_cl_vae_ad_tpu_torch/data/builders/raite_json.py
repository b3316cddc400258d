"""COCO ``labels.json`` from an image directory.

Counterpart of ``trustedai_cl_vae_ad_tpu/data/builders/raite_json.py``, with
the same output: a recursive walk for the given extensions (``.png`` by
default), each image's size read with PIL, a COCO skeleton with no
annotations; ``force_flag`` overwrites an existing file, ``merge_flag``
keeps an existing file's other sections and rebuilds its images list; either
refusal prints an error and exits with status 1.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

from PIL import Image


def build_config_from_directory(
    img_dir: str,
    config_filepath: str,
    force_flag: bool = False,
    merge_flag: bool = False,
    extensions: tuple = (".png",),
) -> dict:
    if not os.path.isdir(img_dir):
        raise FileNotFoundError(f"image directory not found: {img_dir}")

    if os.path.exists(config_filepath):
        if not force_flag and not merge_flag:
            print(f"Error, config filepath exists: {config_filepath}", file=sys.stderr)
            raise SystemExit(1)
    elif merge_flag:
        print(f"Error, file does not exist for merge: {config_filepath}", file=sys.stderr)
        raise SystemExit(1)

    if merge_flag:
        with open(config_filepath, "r") as ifile:
            output_dict = json.load(ifile)
        output_dict["images"] = []
    else:
        output_dict = {
            "info": {
                "year": datetime.datetime.now().year,
                "version": "1.0",
                "description": "custom",
                # the JAX package's value, so both packages write the same file
                "contributor": "trustedai_cl_vae_ad_tpu",
            },
            "categories": [],
            "images": [],
            "annotations": [],
        }

    idx = 0
    for root_path, _dirs, filenames in os.walk(img_dir):
        for f in sorted(filenames):
            if os.path.splitext(f)[1].lower() in extensions:
                with Image.open(os.path.join(root_path, f)) as img:
                    width, height = img.size
                output_dict["images"].append(
                    {"id": idx, "width": width, "height": height, "file_name": f}
                )
                idx += 1

    with open(config_filepath, "w") as ofile:
        json.dump(output_dict, ofile)
    return output_dict
