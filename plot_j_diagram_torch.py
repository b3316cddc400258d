#!/usr/bin/env python3
"""J-diagram (latent attribute arithmetic) figure (PyTorch port).

The counterpart of ``plot_j_diagram.py`` on ``trustedai_cl_vae_ad_tpu_torch``:

  python plot_j_diagram_torch.py <log_dir> <img_a> <img_b> <img_c> [-o j_diagram.png]
         [-n 11] [--device cuda]

Encodes the source image A and the attribute images B and C, forms the
attribute vectors zBA = zB - zA and zCA = zC - zA, decodes the grid
z = t0*zBA + t1*zCA + zA over t in [0, 1]^2 in one batch on the device, and
draws an (N + 1) x (N + 1) figure with the Source / Attr. 1 / Attr. 2 corners.
"""

import argparse
import os

import numpy as np


def get_args(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("log_dir", type=str, help="Log Directory containing model and config")
    parser.add_argument("img_a", type=str, help="Source image A")
    parser.add_argument("img_b", type=str, help="Attribute-1 image B")
    parser.add_argument("img_c", type=str, help="Attribute-2 image C")
    parser.add_argument("--output-filename", "-o", type=str, default="j_diagram.png")
    parser.add_argument("--grid-size", "-n", type=int, default=11)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    args.device = checked_device(parser, args.device)
    return args


def load_images(paths, config: dict, device="cuda"):
    """The images at ``paths`` as one (3, H, W, C) float32 batch on ``device``,
    each resized to the model's input on its own (attribute images come from
    different sources and resolutions)."""
    import torch
    from PIL import Image

    from trustedai_cl_vae_ad_tpu_torch.data.ingest import preprocess_batch

    out = []
    for p in paths:
        assert os.path.isfile(p), p
        with Image.open(p) as img:
            arr = np.array(img.convert("RGB"))
        out.append(preprocess_batch(arr[None], config["data"]["image_size"], device))
    return torch.cat(out, dim=0)


def plot_j_diagram(model, imgs, output_filename: str, N: int = 11):
    """Draw the figure; returns the decoded grid (N*N, H, W, C), cell i*N + j
    at t0 = t[i], t1 = t[j]."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.data.loader import host_images
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import labelled_grid

    imgs = torch.as_tensor(imgs).to(model.device)
    if imgs.dtype == torch.uint8:
        # uint8 contract: raw 0-255 pixels (imgs are also drawn below)
        imgs = imgs.to(torch.float32) / 255.0
    _, z, _, _ = model.call_detailed(imgs)
    z0, zba, zca = (v.to(torch.float64) for v in (z[0], z[1] - z[0], z[2] - z[0]))

    # the grid in float64, as numpy makes it from linspace's float64 steps, then float32
    t_vec = torch.from_numpy(np.linspace(0.0, 1.0, N)).to(model.device)
    t0, t1 = t_vec.repeat_interleave(N)[:, None], t_vec.repeat(N)[:, None]
    grid_z = (t0 * zba + t1 * zca + z0).to(torch.float32)
    grid_imgs = model.decode(grid_z, apply_sigmoid=True).cpu().numpy()

    shown = host_images(imgs)
    cells = [[None] * (N + 1) for _ in range(N + 1)]
    cells[0][0] = (shown[0], "Source")
    cells[0][N] = (shown[1], "Attr. 1")
    cells[N][0] = (shown[2], "Attr. 2")
    for i in range(N):
        for j in range(N):
            cells[j + 1][i + 1] = grid_imgs[i * N + j]
    print(f"Saving J-Diagram: {output_filename}")
    labelled_grid(cells, output_filename, title="J-Diagram")
    return grid_imgs


def main(argv=None):
    args = get_args(argv)

    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    model, config = load_model_from_directory(args.log_dir, device=args.device)
    imgs = load_images([args.img_a, args.img_b, args.img_c], config, args.device)
    return plot_j_diagram(model, imgs, args.output_filename, args.grid_size)


if __name__ == "__main__":
    main()
