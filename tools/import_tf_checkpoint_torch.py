#!/usr/bin/env python3
"""Convert a reference TF SavedModel log directory into the PyTorch port's checkpoint.

Usage:
  python tools/import_tf_checkpoint_torch.py <ref_logdir> <out_logdir> [--verify] [--device cuda]

<ref_logdir> is a log directory of the reference (gtemplin/TrustedAI-CL-VAE-AD):
``encoder/`` + ``decoder/`` Keras SavedModels + ``config.yml``. The weights are
read without TensorFlow (``trustedai_cl_vae_ad_tpu_torch/train/tf_import.py``),
put on the device, and <out_logdir> receives the same ``config.yml`` and one
checkpoint round of the port (``train/checkpoint.py``), without Adam state,
which every ``*_torch.py`` entry point loads with ``-m <out_logdir>``.

--verify also runs the SavedModels' serving signatures (this needs
TensorFlow, imported only then) on a seeded batch and asserts a latent and a
reconstruction MSE below 1e-5 against the port's forward.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PARITY_MSE = 1e-5


def verify(ref_dir: str, model, config: dict) -> tuple:
    """(latent MSE, reconstruction MSE) of the port's forward against the
    SavedModels' serving signatures on a seeded batch of 2."""
    import numpy as np
    import tensorflow as tf

    size = config["data"]["image_size"]
    x = np.random.RandomState(0).random((2, size[0], size[1], size[2])).astype(np.float32)

    def serve(part, value):
        loaded = tf.saved_model.load(os.path.join(ref_dir, part))
        fn = loaded.signatures.get("serving_default") or next(iter(loaded.signatures.values()))
        return list(fn(tf.constant(value)).values())[0].numpy()

    tf_latent = serve("encoder", x)
    ours_latent = np.concatenate([m.float().cpu().numpy() for m in model.encode(x)], axis=1)
    mse_latent = float(np.mean((tf_latent - ours_latent) ** 2))
    mean = tf_latent[:, : tf_latent.shape[1] // 2]
    tf_rec = serve("decoder", mean)
    ours_rec = model.decode(mean, apply_sigmoid=False).float().cpu().numpy()
    mse_rec = float(np.mean((tf_rec - ours_rec) ** 2))
    return mse_latent, mse_rec


def main(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ref_dir", help="reference log directory (encoder/ decoder/ config.yml)")
    parser.add_argument("out_dir", help="log directory to write the port's checkpoint into")
    parser.add_argument("--verify", action="store_true",
                        help="run the SavedModels too (needs tensorflow) and assert MSE < 1e-5")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    checked_device(parser, args.device)
    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.train.tf_import import import_tf_checkpoint

    timings = {}
    model, config = import_tf_checkpoint(args.ref_dir, device=args.device, timings=timings)
    t0 = time.perf_counter()
    os.makedirs(args.out_dir, exist_ok=True)
    model.save_model(args.out_dir, include_optimizer=False)
    save_config(config, os.path.join(args.out_dir, "config.yml"))
    save_s = time.perf_counter() - t0
    print(f"Imported TF checkpoint {args.ref_dir} -> {args.out_dir} on {args.device}: "
          f"read {timings['read_s']:.3f} s, onto the device {timings['load_s']:.3f} s, "
          f"saved {save_s:.3f} s")

    if args.verify:
        mse_latent, mse_rec = verify(args.ref_dir, model, config)
        print(f"verify: latent MSE {mse_latent:.3e}, reconstruction MSE {mse_rec:.3e}")
        if not (mse_latent < PARITY_MSE and mse_rec < PARITY_MSE):
            print(f"parity target missed (MSE >= {PARITY_MSE:g})", file=sys.stderr)
            return 1
        print("parity OK (<1e-5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
