#!/usr/bin/env python3
"""Decode a uniform latent sample grid (PyTorch port).

The counterpart of ``sample_latent_space.py`` on ``trustedai_cl_vae_ad_tpu_torch``:

  python sample_latent_space_torch.py <log_dir> [-o latent_sample.png] [--min-z -1]
         [--max-z 1] [--device cuda]

Draws N*N = 100 latent vectors uniform in [min_z, max_z] from numpy's global
random state, exactly as the JAX tool draws them (so one ``np.random.seed``
gives both the same z), decodes them with sigmoid in one batch on the device,
and draws a 10 x 10 grid.
"""

import argparse

import numpy as np


def get_args(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("log_dir", type=str, help="Log filepath directory")
    parser.add_argument("--output-filename", "-o", type=str, default="latent_sample.png")
    parser.add_argument("--min-z", type=float, default=-1.0)
    parser.add_argument("--max-z", type=float, default=+1.0)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    args.device = checked_device(parser, args.device)
    return args


def sample_latent_space(config: dict, model, output_filename: str, min_z: float, max_z: float,
                        N: int = 10):
    """Draw the grid; returns the decoded images (N*N, H, W, C)."""
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import labelled_grid

    latent_dim = config["model"]["latent_dimensions"]
    print(f"Sample Size: {(N * N, latent_dim)}")
    z_sample = np.random.random(size=(N * N, latent_dim)) * (max_z - min_z) + min_z
    x_r = model.decode(z_sample.astype(np.float32), apply_sigmoid=True).cpu().numpy()
    print(f"Reconstruction Size: {x_r.shape}")

    labelled_grid([[x_r[row * N + col] for col in range(N)] for row in range(N)],
                  output_filename)
    return x_r


def main(argv=None):
    args = get_args(argv)

    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    model, config = load_model_from_directory(args.log_dir, device=args.device)
    return sample_latent_space(config, model, args.output_filename, args.min_z, args.max_z)


if __name__ == "__main__":
    main()
