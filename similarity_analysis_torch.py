#!/usr/bin/env python3
"""Pairwise latent-space similarity analysis (PyTorch port).

The counterpart of ``similarity_analysis.py`` on ``trustedai_cl_vae_ad_tpu_torch``:

  python similarity_analysis_torch.py -m <model_dir> -d <dataset_dir> [-o <output_dir>]
         [-f] [--device cuda]

Encodes the train split of the dataset with its file paths, standardizes the
latents (each column's mean and std from one launch of the per-dimension
moments kernel), computes the full euclidean and cosine distance matrices on
the device, and writes into ``<output_dir or model_dir>/similarity``: the
nested file -> file -> {euclidean, cosine} ``distances.json``, a 2 x 2 summary
figure (the distance histograms and the latent histograms) and one histogram
PNG a latent column, titled with its mean, std and kurtosis. ``-f`` replaces
an existing output directory.
"""

import argparse
import concurrent.futures as cf
import json
import os
import shutil
import time
from collections import defaultdict, deque

import numpy as np

# the most histogram pages drawn and waiting for their encode
_IN_FLIGHT = 32


def get_args(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--model-dir", "-m", required=True, type=str)
    parser.add_argument("--dataset-dir", "-d", required=True, type=str)
    parser.add_argument("--output-dir", "-o", type=str, default=None,
                        help="Override output path")
    parser.add_argument("--force", "-f", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = checked_device(parser, args.device)

    # output lands in <output_dir or model_dir>/similarity
    base = args.output_dir if args.output_dir else args.model_dir
    sim_dir = os.path.join(base, "similarity")
    if not args.force:
        assert not os.path.exists(sim_dir), f"output exists (use --force): {sim_dir}"
        os.makedirs(sim_dir)
    else:
        if os.path.exists(sim_dir):
            assert not os.path.isfile(sim_dir)
            shutil.rmtree(sim_dir)
        os.makedirs(sim_dir, exist_ok=True)
    return args.model_dir, args.dataset_dir, sim_dir, device


def _image_path_pairs(data: dict):
    """(images, file paths) a batch: the loader's single-pass 'train_full'
    stream where it has one (RAITE), else the train split, whose batches
    without a 'filepath' get stable ``item_%06d`` identifiers."""
    if "train_full" in data:
        yield from ((b["image"], b["filepath"]) for b in data["train_full"])
        return
    idx = 0
    for b in data["train"]:
        img = b["image"] if isinstance(b, dict) else b
        if isinstance(b, dict) and "filepath" in b:
            fps = b["filepath"]
        else:
            fps = [f"item_{idx + j:06d}" for j in range(len(img))]
        idx += len(img)
        yield img, fps


def _latent_hists(sim_dir, z_samples, mean, std, kurtosis) -> None:
    """One histogram PNG a latent column. Each page is drawn in this thread
    and encoded on a pool of 8 (PIL's encoder releases the interpreter lock;
    its drawing does not, so drawing on the pool only contends), at most
    ``_IN_FLIGHT`` pages waiting."""
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import histogram_panel

    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        futs = deque()
        for idx in range(z_samples.shape[1]):
            col = z_samples[:, idx]
            page = histogram_panel(
                {"z": col},
                f"Latent Element #:{idx} Histogram \nN= {len(col)}, Mean= {mean[idx]:0.3f}, "
                f"Std.Dev= {std[idx]:0.3f}, Kurtosis= {kurtosis[idx]:0.3f}",
                density=True, xlabel="Latent Space Value", ylabel="Density")
            futs.append(pool.submit(page.save, os.path.join(sim_dir,
                                                            f"latent_hist_{idx:03d}.png")))
            while len(futs) > _IN_FLIGHT:
                futs.popleft().result()
        for f in futs:
            f.result()


def similarity_analysis(model, config: dict, data: dict, sim_dir: str) -> dict:
    """Write the artifacts; returns the host arrays they were made from ('z',
    'filepaths', 'mean', 'std', 'kurtosis', 'euclidean', 'cosine') and the
    seconds of the distances, of distances.json and of the histograms."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.viz.latent import (
        latent_moments,
        pairwise_distances,
        standardize,
    )
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import histogram_panel, panels

    zs, filepaths = [], []
    for batch_img, batch_filepath in _image_path_pairs(data):
        # call_detailed handles the uint8 contract itself
        zs.append(model.call_detailed(batch_img)[1])
        filepaths.extend(str(p) for p in batch_filepath)
    z = torch.cat(zs, dim=0)

    print("Standardize latent space")
    moments = latent_moments(z)
    z_scores, _, _ = standardize(z, moments)
    seconds = {}
    t0 = time.perf_counter()
    euclidean_distance = pairwise_distances(z_scores, metric="euclidean").cpu().numpy()
    cosine_distance = pairwise_distances(z_scores, metric="cosine").cpu().numpy()
    seconds["distances"] = time.perf_counter() - t0
    upper = np.triu_indices_from(euclidean_distance, k=1)
    flat_euclidean, flat_cosine = euclidean_distance[upper], cosine_distance[upper]

    t0 = time.perf_counter()
    lookup = defaultdict(lambda: defaultdict(dict))
    euc_rows, cos_rows = euclidean_distance.tolist(), cosine_distance.tolist()
    for idx_1, f1 in enumerate(filepaths):  # f1 -> f2 for idx_1 > idx_2
        for idx_2 in range(idx_1):
            lookup[f1][filepaths[idx_2]]["euclidean"] = euc_rows[idx_1][idx_2]
            lookup[f1][filepaths[idx_2]]["cosine"] = cos_rows[idx_1][idx_2]
    distances_path = os.path.join(sim_dir, "distances.json")
    print(f"Saving distances to file: {distances_path}")
    with open(distances_path, "w") as ofile:
        json.dump(lookup, ofile)
    seconds["distances_json"] = time.perf_counter() - t0

    print("Generating plots")
    t0 = time.perf_counter()
    z_samples = z.cpu().numpy()
    mean, std, kurtosis = (m.cpu().numpy() for m in moments)
    common = dict(density=True, ylabel="Density")
    panels([
        histogram_panel({"euclidean": flat_euclidean}, "Euclidean Distance Histogram",
                        xlabel="Euclidean Distance", **common),
        histogram_panel({"z": z_samples}, "Full Z Histogram", xlabel="Latent Space Value",
                        **common),
        histogram_panel({"cosine": flat_cosine}, "Cosine Distance Histogram",
                        xlabel="Cosine Distance", **common),
        histogram_panel({str(idx): z_samples[:, idx] for idx in range(z_samples.shape[1])},
                        f"Individual Z-vec Histogram: {z_samples.shape[1]}",
                        xlabel="Latent Space Value", alpha=0.35, legend=False, **common),
    ], os.path.join(sim_dir, "similarity_figure.png"),
        "Distance Metrics and Latent Space Histograms", cols=2)
    _latent_hists(sim_dir, z_samples, mean, std, kurtosis)
    seconds["histograms"] = time.perf_counter() - t0
    return {"z": z_samples, "filepaths": filepaths, "mean": mean, "std": std,
            "kurtosis": kurtosis, "euclidean": euclidean_distance, "cosine": cosine_distance,
            "seconds": seconds}


def main(argv=None):
    model_dir, dataset_dir, output_dir, device = get_args(argv)

    from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    model, config = load_model_from_directory(model_dir, device=device)
    config["data"]["dataset_path"] = dataset_dir
    data = load_data(config, device=device)
    return similarity_analysis(model, config, data, output_dir)


if __name__ == "__main__":
    main()
