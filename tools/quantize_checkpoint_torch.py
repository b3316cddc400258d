#!/usr/bin/env python3
"""Write an int8 serving checkpoint beside a trained log directory (PyTorch port).

Usage:
  python tools/quantize_checkpoint_torch.py -m <logdir> [--min-elems N] [--device cuda]

Loads the float checkpoint that ``train_torch.py`` (or the JAX package's
``train.py``) wrote, quantizes the large Dense kernels
(``trustedai_cl_vae_ad_tpu_torch/ops/quant.py``: symmetric int8 with one
scale per output channel) and persists the serving tree under
``<logdir>/quantized``. After this, ``camera_streamer_torch.py -m <logdir>
--quantize`` (without ``-c``) boots from the int8 tree: the float weights are
neither read nor put on the device, and no quantization pass runs at boot.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--model-dir", "-m", required=True)
    parser.add_argument("--min-elems", type=int, default=None,
                        help="quantize Dense kernels with at least this many elements "
                             "(default ops/quant.DEFAULT_MIN_ELEMS)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    checked_device(parser, args.device)
    from trustedai_cl_vae_ad_tpu_torch.ops.quant import (
        quantize_params,
        save_quantized_checkpoint,
        tree_nbytes,
    )
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    model, _config = load_model_from_directory(args.model_dir, device=args.device)
    qparams = quantize_params(model.core, model.params, min_elems=args.min_elems)
    path = save_quantized_checkpoint(args.model_dir, qparams)
    print(f"quantized checkpoint written: {path} ({tree_nbytes(qparams) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
