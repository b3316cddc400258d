#!/usr/bin/env python3
"""Export a log directory of the PyTorch port to the reference's TF SavedModel layout.

Usage:
  python tools/export_tf_checkpoint_torch.py <our_logdir> <out_dir> [--device cuda]

<out_dir> receives ``encoder/`` + ``decoder/`` SavedModels + ``config.yml``
(``trustedai_cl_vae_ad_tpu_torch/train/tf_export.py``), which the reference's
TensorFlow tooling and ``tools/import_tf_checkpoint_torch.py`` read. Needs
tensorflow; without it the tool exits 1 and writes nothing.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("log_dir", help="Our log dir (encoder/ decoder/ + config.yml)")
    parser.add_argument("out_dir", help="Output dir for the TF SavedModel layout")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    checked_device(parser, args.device)

    from trustedai_cl_vae_ad_tpu_torch.train.tf_export import export_tf_checkpoint

    try:
        enc, dec = export_tf_checkpoint(args.log_dir, args.out_dir, device=args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"Exported TF SavedModels: {enc}, {dec}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
