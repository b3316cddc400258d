#!/usr/bin/env python3
"""Reorganize raw RAITE event captures into per-match datasets (the PyTorch
port's counterpart of ``fix_raite_event_data.py``, same flags):

  python fix_raite_event_data_torch.py ROOT_DIR [OUTPUT_DIR | -o OUTPUT_DIR] [--force]

Writes ``<out>/<camera-N>/<match_N|still>/frames/`` (each frame's channels
swapped), a ``labels.json`` beside each ``frames/`` and ``<out>/original_map.csv``.
The captures are read, never moved. Host code only: it uses no device.
"""

import argparse
import os
import sys

from trustedai_cl_vae_ad_tpu_torch.data.builders.fix_raite import fix_raite_event_data


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("root_dir", type=str, help="Root directory of raw event captures")
    parser.add_argument("output_dir", type=str, nargs="?", default=None,
                        help="Output directory (== --output-dir)")
    parser.add_argument("--output-dir", "-o", type=str, default=None,
                        dest="output_dir_opt", help="Path to output directory")
    parser.add_argument("--force", "-f", action="store_true", help="Allow existing output dir")
    args = parser.parse_args(argv)
    args.output_dir = args.output_dir or args.output_dir_opt
    if args.output_dir is None:
        parser.error("provide an output directory (positional or -o)")
    if not os.path.isdir(args.root_dir):
        parser.error(f"not a directory: {args.root_dir}")
    if os.path.exists(args.output_dir):
        if not args.force:
            print(
                f"Error, output path exists (call --force to overwrite): {args.output_dir}",
                file=sys.stderr,
            )
            raise SystemExit(1)
        if not os.path.isdir(args.output_dir):
            parser.error(f"output path is not a directory: {args.output_dir}")
    else:
        os.makedirs(args.output_dir)
    return args


def main(argv=None):
    args = get_args(argv)
    fix_raite_event_data(args.root_dir, args.output_dir)
    return 0


if __name__ == "__main__":
    main()
