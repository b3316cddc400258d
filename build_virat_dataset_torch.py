#!/usr/bin/env python3
"""A VIRAT root (``videos_original/`` and ``annotations/``) into frame records
and, with ``--extract-frames STRIDE``, a trainable saved dataset of every
STRIDE-th frame (the PyTorch port's counterpart of ``build_virat_dataset.py``,
same flags):

  python build_virat_dataset_torch.py VIRAT_ROOT [-o virat_dataset]
      [--extract-frames STRIDE] [--max-frames-per-video N] [-b 32]

Host code only: it uses no device.
"""

import argparse

from trustedai_cl_vae_ad_tpu_torch.data.builders.virat import (
    create_dataset,
    extract_frames,
    load_meta_data,
)


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("virat_directory", type=str, help="VIRAT root directory")
    parser.add_argument("--output-path", "-o", type=str, default="virat_dataset")
    parser.add_argument(
        "--extract-frames", type=int, default=0, metavar="STRIDE",
        help="Also decode every STRIDE-th video frame into a trainable saved dataset",
    )
    parser.add_argument("--max-frames-per-video", type=int, default=None)
    parser.add_argument("--batchsize", "-b", type=int, default=32,
                        help="Batch size of the extracted frames")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    meta_data = load_meta_data(args.virat_directory)
    create_dataset(meta_data, args.output_path)
    if args.extract_frames > 0:
        extract_frames(
            meta_data, args.output_path, frame_stride=args.extract_frames,
            max_frames_per_video=args.max_frames_per_video,
            batch_size=args.batchsize,
        )
    return 0


if __name__ == "__main__":
    main()
