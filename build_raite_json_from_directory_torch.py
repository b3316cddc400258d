#!/usr/bin/env python3
"""Build a COCO labels.json from an image directory (the PyTorch port's
counterpart of ``build_raite_json_from_directory.py``, same flags):

  python build_raite_json_from_directory_torch.py IMG_DIR [-c labels.json] [-f | -m]
      [-e .png .jpg]

Host code only: it uses no device.
"""

import argparse

from trustedai_cl_vae_ad_tpu_torch.data.builders.raite_json import build_config_from_directory


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("img_dir", type=str, help="Directory with images")
    parser.add_argument(
        "--config-filepath", "-c", type=str, default="labels.json",
        help="Output path for config file (default: labels.json)",
    )
    parser.add_argument("--force-flag", "-f", action="store_true", help="Force config overwrite")
    parser.add_argument(
        "--merge-flag", "-m", action="store_true", help="Merges changes from provided config file"
    )
    parser.add_argument(
        "--extensions", "-e", nargs="+", default=[".png"],
        help="Image extensions to index (default: .png; the decode chain also reads "
             ".jpg/.jpeg)",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    exts = tuple(e if e.startswith(".") else f".{e}" for e in args.extensions)
    build_config_from_directory(args.img_dir, args.config_filepath, args.force_flag,
                                args.merge_flag, extensions=exts)
    return 0


if __name__ == "__main__":
    main()
