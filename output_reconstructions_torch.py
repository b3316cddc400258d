#!/usr/bin/env python3
"""Dump originals, reconstructions, error maps and JET heatmap overlays (PyTorch port).

The counterpart of ``output_reconstructions.py`` on
``trustedai_cl_vae_ad_tpu_torch``:

  python output_reconstructions_torch.py <log_dir> [--device cuda]

For the train and validation splits of the log directory's config it writes
``imgs/{originals,reconstructions,errors,heatmap}/{train,val}/<n>.png``, the
per-image error sqrt(sum of squared pixel errors) as
``train_reconstruction_error.json`` / ``val_reconstruction_error.json``, and
``reconstruction_hist.png``. Heatmaps are normalized by the split's global
error minimum and maximum. The forward, the per-pixel error map and its sum
are one device computation a batch; PNG encoding runs on a pool of 8 threads.
"""

import argparse
import concurrent.futures as cf
import json
import os

import numpy as np


def get_args(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("log_dir", type=str, help="Model Directory")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    args.device = checked_device(parser, args.device)
    return args


def _drain(futs):
    for f in futs:
        f.result()
    futs.clear()


def process_train_val_reconstructions(log_dir: str, model, config: dict, data: dict):
    """Write the artifacts of both splits; returns (train errors, val errors),
    each {image number: error}."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.viz.plots import histogram, overlay_heatmap, save_rgb

    assert os.path.isdir(log_dir)
    core = model.core

    def fwd_err(x):
        with torch.inference_mode():
            x_hat = core.call(x)
            err_map = torch.sum((x - x_hat) ** 2, dim=3)
            scalar_err = torch.sqrt(torch.sum(err_map, dim=(1, 2)))
            lo, hi = torch.aminmax(err_map)

            def u8(t):
                return torch.clamp(torch.round(255.0 * t), 0, 255).to(torch.uint8).cpu().numpy()

            return (u8(x), u8(x_hat), err_map.to(torch.float16).cpu().numpy(),
                    scalar_err.cpu().numpy(), float(lo), float(hi))

    def process_split(split_data, split: str) -> dict:
        """Two streamed passes, host memory O(batch): the heatmaps' normalizer
        is the split's global error min / max, so pass 1 writes originals and
        reconstructions and spills each error map to a float16 .npy sidecar,
        and pass 2 normalizes them into error and heatmap PNGs and deletes the
        sidecars."""
        orig_dir = os.path.join(log_dir, f"imgs/originals/{split}")
        rec_dir = os.path.join(log_dir, f"imgs/reconstructions/{split}")
        heat_dir = os.path.join(log_dir, f"imgs/heatmap/{split}")
        err_dir = os.path.join(log_dir, f"imgs/errors/{split}")
        for d in (orig_dir, rec_dir, heat_dir, err_dir):
            os.makedirs(d, exist_ok=True)

        rec_err = {}
        img_num = 0
        emin, emax = np.inf, -np.inf
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            futs = []
            for batch in split_data:
                x = torch.as_tensor(batch["image"] if isinstance(batch, dict) else batch)
                x = x.to(model.device)
                # uint8 contract: raw 0-255 pixels (x also feeds the error maps and the
                # originals)
                x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.to(torch.float32)
                orig_u8, rec_u8, em16, se, lo, hi = fwd_err(x)
                emin, emax = min(emin, lo), max(emax, hi)
                for i in range(len(orig_u8)):
                    futs.append(pool.submit(save_rgb, orig_u8[i],
                                            os.path.join(orig_dir, f"{img_num}.png")))
                    futs.append(pool.submit(save_rgb, rec_u8[i],
                                            os.path.join(rec_dir, f"{img_num}.png")))
                    futs.append(pool.submit(np.save, os.path.join(err_dir, f"{img_num}.npy"),
                                            em16[i]))
                    rec_err[img_num] = float(se[i])
                    img_num += 1
                if len(futs) > 512:  # bound the encodes in flight
                    _drain(futs)
            _drain(futs)

        if img_num:
            scale = (emax - emin) if emax > emin else 1.0

            def heatmap(k):
                from PIL import Image

                npy = os.path.join(err_dir, f"{k}.npy")
                m = np.load(npy).astype(np.float32)
                os.remove(npy)
                err_u8 = np.clip(np.round(255.0 * (m - emin) / scale), 0, 255).astype(np.uint8)
                save_rgb(err_u8, os.path.join(err_dir, f"{k}.png"))
                with Image.open(os.path.join(orig_dir, f"{k}.png")) as img:
                    orig = np.asarray(img)
                if orig.ndim == 2:
                    orig = orig[..., None]
                save_rgb(overlay_heatmap(err_u8, orig), os.path.join(heat_dir, f"{k}.png"))

            with cf.ThreadPoolExecutor(max_workers=8) as pool:
                _drain([pool.submit(heatmap, k) for k in range(img_num)])
        return rec_err

    train_err = process_split(data["train"], "train")
    with open(os.path.join(log_dir, "train_reconstruction_error.json"), "w") as f:
        json.dump(train_err, f)
    val_err = {}
    if data.get("val") is not None:
        val_err = process_split(data["val"], "val")
        with open(os.path.join(log_dir, "val_reconstruction_error.json"), "w") as f:
            json.dump(val_err, f)

    series = {"train": np.asarray(list(train_err.values()))}
    if val_err:
        series["val"] = np.asarray(list(val_err.values()))
    histogram(
        os.path.join(log_dir, "reconstruction_hist.png"),
        series,
        "Reconstruction Error Histogram",
        xlabel="Reconstruction Error (MSE)",
        ylabel="Counts",
    )
    return train_err, val_err


def main(argv=None):
    args = get_args(argv)

    from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    model, config = load_model_from_directory(args.log_dir, device=args.device)
    data = load_data(config, device=args.device)
    return process_train_val_reconstructions(args.log_dir, model, config, data)


if __name__ == "__main__":
    main()
