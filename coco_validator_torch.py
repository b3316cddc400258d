#!/usr/bin/env python3
"""Validate a COCO labels.json (the PyTorch port's counterpart of
``coco_validator.py``): ``python coco_validator_torch.py labels.json``.

Prints ``OK: ...`` with the counts, or raises ``ValueError`` at the first
structural fault (``data/coco.py::validate_coco_data``). Host code only: it
uses no device.
"""

import argparse
import json

from trustedai_cl_vae_ad_tpu_torch.data.coco import validate_coco_data


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("json_path", type=str, help="COCO labels.json to validate")
    args = parser.parse_args(argv)

    with open(args.json_path) as f:
        data = json.load(f)
    validate_coco_data(data)
    print(f"OK: {args.json_path} ({len(data['images'])} images, "
          f"{len(data['annotations'])} annotations)")
    return 0


if __name__ == "__main__":
    main()
