#!/usr/bin/env python3
"""Latent-space linear interpolation grid (PyTorch port).

The counterpart of ``interpolate.py`` on ``trustedai_cl_vae_ad_tpu_torch``:

  python interpolate_torch.py <log_dir> [-k 10] [-o interpolate_output.png] [--device cuda]

Encodes 2N images of the config's dataset (validation split, else train),
walks z0 -> z1 in k steps of (z1 - z0) / k, decodes every step with sigmoid
in one batch on the device, and draws an N x (k + 2) grid with X0 / t_i / X1
over the first row.
"""

import argparse

import numpy as np


def get_args(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("log_dir", type=str, help="Log Directory containing model and config")
    parser.add_argument("--sample-points", "-k", type=int, default=10,
                        help="Number of samples to walk")
    parser.add_argument("--output-path", "-o", type=str, default="interpolate_output.png")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    args.device = checked_device(parser, args.device)
    return args


def example_interpolate(config: dict, model, output_path: str, k_sample_points: int = 10,
                        N: int = 10):
    """Draw the grid; returns its columns as an array (k + 2, N, H, W, C):
    X0, the k decoded steps, X1."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.data.loader import host_images, iter_images, load_data
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import labelled_grid

    data = load_data(config, device=model.device)
    xs = []
    for img in iter_images(data["val"] if data.get("val") is not None else data["train"]):
        xs.append(host_images(img))
        if sum(b.shape[0] for b in xs) >= 2 * N:
            break
    x = np.concatenate(xs, axis=0)
    N = min(N, len(x) // 2)
    assert N > 0, "need at least 2 images to interpolate"
    x = x[: 2 * N]

    _, z, _, _ = model.call_detailed(torch.from_numpy(x).to(model.device))
    z0, z1 = z[:N], z[N:]
    z_delta = (z1 - z0) / k_sample_points
    steps = torch.stack([z0 + z_delta * t for t in range(k_sample_points)])
    decoded = model.decode(steps.reshape(k_sample_points * N, -1), apply_sigmoid=True)
    decoded = decoded.reshape(k_sample_points, N, *decoded.shape[1:]).cpu().numpy()
    columns = np.concatenate([x[None, :N], decoded, x[None, N:]], axis=0)

    labels = ["X0"] + [f"t{i}" for i in range(k_sample_points)] + ["X1"]
    labelled_grid([[(columns[col][row], labels[col] if row == 0 else None)
                    for col in range(len(columns))] for row in range(N)], output_path)
    return columns


def main(argv=None):
    args = get_args(argv)

    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    model, config = load_model_from_directory(args.log_dir, device=args.device)
    return example_interpolate(config, model, args.output_path, args.sample_points)


if __name__ == "__main__":
    main()
