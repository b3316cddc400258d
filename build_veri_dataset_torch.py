#!/usr/bin/env python3
"""VeRi image directories into a saved train/validation dataset (the PyTorch
port's counterpart of ``build_veri_dataset.py``, same flags):

  python build_veri_dataset_torch.py TRAIN_DIR VAL_DIR [-o VeRi_dataset]

Every image is resized to 224x224 on the host and written in batches of 32;
``configs/veri.yml``'s ``data.dataset_path`` names the output. Host code
only: it uses no device.
"""

import argparse

from trustedai_cl_vae_ad_tpu_torch.data.builders.veri import build_veri_dataset


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("train_path", type=str)
    parser.add_argument("val_path", type=str)
    parser.add_argument("--output-path", "-o", type=str, default="VeRi_dataset")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    build_veri_dataset(args.train_path, args.val_path, args.output_path)
    return 0


if __name__ == "__main__":
    main()
