#!/usr/bin/env python3
"""2-D embedding of the latent space, UMAP or PCA (PyTorch port).

The counterpart of ``plot_umap.py`` on ``trustedai_cl_vae_ad_tpu_torch``:

  python plot_umap_torch.py <log_dir> [-o umap_plot.png] [-n 15] [-d 0.1] [-m euclidean]
         [--standardize] [--interpolate] [-t umap_interp.png] [--device cuda]

Encodes the train and validation latents on the device, standardizes them
with the train split's column statistics when asked (one launch of the
per-dimension moments kernel), fits a 2-D embedding, scatters train against
validation, and with ``--interpolate`` decodes a 10 x 10 grid over the
embedding's range through ``inverse_transform``. The embedding is umap-learn's
UMAP where ``umap`` imports, else ``viz/latent.py::PCAEmbedder``, an exact PCA
on the device (no scikit-learn).
"""

import argparse

import numpy as np


def get_args(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("log_dir", type=str, help="Log Directory containing model and config")
    parser.add_argument("--output-path", "-o", type=str, default="umap_plot.png")
    parser.add_argument("--n-neighbors", "-n", type=int, default=15)
    parser.add_argument("--min-distance", "-d", type=float, default=0.1)
    parser.add_argument("--metric", "-m", type=str, default="euclidean")
    parser.add_argument("--standardize", "-s", action="store_true")
    parser.add_argument("--interpolate", "-i", action="store_true", help="Plot interpolation grid")
    parser.add_argument(
        "--interpolation-output-filename", "-t", type=str, default="umap_interp.png"
    )
    add_device_argument(parser)
    args = parser.parse_args(argv)
    args.device = checked_device(parser, args.device)
    return args


def make_embedder(n_neighbors, min_distance, metric, device="cuda"):
    """(embedder, name): umap-learn's UMAP when it imports, else the PCA."""
    try:
        from umap import UMAP  # type: ignore

        return UMAP(
            n_neighbors=n_neighbors, n_components=2, min_dist=min_distance, metric=metric,
            verbose=True,
        ), "UMAP"
    except ImportError:
        from trustedai_cl_vae_ad_tpu_torch.viz.latent import PCAEmbedder

        print("umap-learn not available; using PCA embedder fallback")
        return PCAEmbedder(device=device), "PCA"


def encode_all(model, split):
    """The latents z of every image of ``split``, (N, L) on the model's device."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.data.loader import iter_images

    # call_detailed handles the uint8 contract itself
    return torch.cat([model.call_detailed(img)[1] for img in iter_images(split)], dim=0)


def plot_umap(data, model, output_path, n_neighbors, min_distance, metric="euclidean",
              standardized_flag=False):
    """Fit and draw the embedding; returns (embedder, train embeddings, val
    embeddings, {'mean', 'std'} of the standardization or None)."""
    from trustedai_cl_vae_ad_tpu_torch.viz.latent import standardize
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import scatter

    z_train = encode_all(model, data["train"])
    z_val = encode_all(model, data["val"]) if data.get("val") is not None else z_train[:0]

    stats = None
    if standardized_flag:
        print("Standardize latent space")
        z_train, z_mean, z_std = standardize(z_train)
        if len(z_val):
            z_val = (z_val - z_mean) / z_std
        stats = {"mean": z_mean.cpu().numpy(), "std": z_std.cpu().numpy()}
    z_train, z_val = z_train.cpu().numpy(), z_val.cpu().numpy()

    embedder, name = make_embedder(n_neighbors, min_distance, metric, model.device)
    embedder.fit(z_train)
    train_embeddings = embedder.transform(z_train)
    val_embeddings = embedder.transform(z_val) if len(z_val) else z_val

    series = {"training": train_embeddings}
    if len(val_embeddings):
        series["validation"] = val_embeddings
    scatter(output_path, series,
            f"{name} Embeddings: Metric: {metric}, Standardized: {standardized_flag}\n"
            f"Latent Dim: {z_train.shape[1]}, N-Neighbors: {n_neighbors}, "
            f"Min Dist: {min_distance}")
    return embedder, train_embeddings, val_embeddings, stats


def plot_interpolation(model, embedder, train_embeddings, val_embeddings, embedding_stats,
                       output_filename):
    """Decode a 10 x 10 grid over the train embeddings' range through
    ``inverse_transform`` and draw it; returns the decoded images (100, H, W, C)."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.viz.plots import labelled_grid

    max_values = np.max(train_embeddings, axis=0)
    min_values = np.min(train_embeddings, axis=0)
    xs = np.linspace(min_values[0], max_values[0], 10)
    ys = np.linspace(min_values[1], max_values[1], 10)
    samples = np.array([[x, y] for x in xs for y in ys], dtype=np.float32)

    z = torch.as_tensor(np.asarray(embedder.inverse_transform(samples), np.float32))
    z = z.to(model.device)
    if embedding_stats:
        z = (z * torch.as_tensor(embedding_stats["std"]).to(model.device)
             + torch.as_tensor(embedding_stats["mean"]).to(model.device))
    reconstructions = model.decode(z, apply_sigmoid=True).cpu().numpy()

    labelled_grid([[reconstructions[i * 10 + j] for j in range(10)] for i in range(10)],
                  output_filename)
    return reconstructions


def main(argv=None):
    args = get_args(argv)

    from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    model, config = load_model_from_directory(args.log_dir, device=args.device)
    data = load_data(config, device=args.device)
    embedder, train_emb, val_emb, stats = plot_umap(
        data, model, args.output_path, args.n_neighbors, args.min_distance, args.metric,
        args.standardize,
    )
    if args.interpolate:
        plot_interpolation(model, embedder, train_emb, val_emb, stats,
                           args.interpolation_output_filename)
    return embedder, train_emb, val_emb, stats


if __name__ == "__main__":
    main()
