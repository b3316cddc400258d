"""Offline anomaly scoring: two-pass reference-distribution z-scoring.

Counterpart of ``trustedai_cl_vae_ad_tpu/anomaly/offline.py``:
  * pass 1 (``get_data_scale``): per-frame error eps = sum over pixels of the
    channel-summed (x - x_hat)^2 on the TRAINING data -> meu, sigma, min,
    max, z_scores;
  * pass 2 (``evaluate_anomalies``): per-frame z = (eps - meu) / sigma on the
    evaluation data, per-pixel normalized error maps, anomalies = z >
    threshold;
  * outputs (``output_anomalies``): the z-score histogram, per-frame PNG
    dumps (err / JET heatmap / overlay / reconstruction / original) and
    ``anomaly_list.csv`` sorted by z.

A batch's forward and its reductions run on the model's device; only the
per-frame scalars (and, in pass 2, the maps that become PNGs or that the
caller keeps) are copied to the host. With ``quantize`` both passes run the
``w8a8`` forward of ``ops/quant.py``, whose Dense products are the int8 GEMM
kernel on the card. With ``mesh`` (a one-process mesh of local devices,
``parallel/mesh.py``) each batch is padded to a multiple of the devices,
split into one block of rows a device, and scored by one model replica a
device; the results are gathered on the model's device in row order and the
pad rows dropped, so results pair with frames by index.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import csv
import os

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.data.loader import host_images, iter_images
from trustedai_cl_vae_ad_tpu_torch.viz.plots import jet_heatmap


@torch.inference_mode()
def _batch_err(forward, params, x):
    err = ((x - forward(params, x)) ** 2).sum(dim=3)  # per pixel, channel-summed
    return err.sum(dim=(1, 2)), err.amin(), err.amax()


@torch.inference_mode()
def _batch_eval(forward, params, x, mu, sigma, emin, emax):
    x_rec = forward(params, x)
    err = ((x - x_rec) ** 2).sum(dim=3)
    z = (err.sum(dim=(1, 2)) - mu) / sigma
    norm_err = (err - emin) / (emax - emin)
    return x_rec, err, z, norm_err


def _replicas(core, forward, score_params, quantize: bool, mesh) -> list:
    """[(forward, params)] of each device of the mesh: the quantized tree on
    each device, or the float core where it lies and a copy elsewhere."""
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import replicate

    if quantize:
        return [(forward, tree) for tree in replicate(score_params, mesh)]
    home = next(core.parameters()).device
    out = []
    for d in mesh.devices:
        if d == home:
            out.append((forward, score_params))
        else:
            twin = copy.deepcopy(core).to(d)
            out.append((lambda _p, x, twin=twin: twin(x), None))
    return out


def _score_fns(model, mesh=None, quantize=False, score_params=None):
    """``(batch_err, batch_eval, place, score_params)`` of the two passes on
    ``model.device``. With ``quantize`` the forward is ``call_quantized`` on a
    quantized tree, returned as ``score_params`` so that a caller running
    both passes quantizes once; a tree passed in as ``score_params`` is used
    as it is (the forward that matches it is picked). Eval mode: z = mean +
    0.5 * logvar, so the quantized eval forward is the same computation.
    With ``mesh`` both passes run each device's rows on its replica and
    return the whole (padded) batch's results on the model's device."""
    from trustedai_cl_vae_ad_tpu_torch.ops import quant
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import Mesh

    if mesh is not None and (not isinstance(mesh, Mesh) or mesh.distributed):
        raise TypeError("offline scoring takes a one-process mesh of local devices "
                        f"(parallel.mesh.make_mesh(devices=...)), not {mesh!r}")
    core = model.core
    device = torch.device(model.device)
    if score_params is None:
        forward, score_params = quant.serving_forward(core, model.params, quantize=quantize)
    elif quantize:
        def forward(p, x):
            return quant.call_quantized(core, p, x)
    else:
        def forward(_p, x):
            return core(x)

    def batch_err(params, x):
        return _batch_err(forward, params, x)

    def batch_eval(params, x, mu, sigma, emin, emax):
        return _batch_eval(forward, params, x, mu, sigma, emin, emax)

    def place(x):
        # uint8 means raw 0-255 pixels (the package-wide contract); the
        # loaders' device streams arrive normalized float32 already
        x = torch.as_tensor(x).to(device)
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        return x.to(torch.float32), int(x.shape[0])

    if mesh is None:
        return batch_err, batch_eval, place, score_params

    from trustedai_cl_vae_ad_tpu_torch.parallel.dp import build_forward_step

    replicas = _replicas(core, forward, score_params, quantize, mesh)
    err_step = build_forward_step(lambda r, rows: _batch_err(*r, rows), mesh, replicas)
    eval_step = build_forward_step(lambda r, rows, *a: _batch_eval(*r, rows, *a), mesh, replicas)

    def gathered(outs):
        """Each output's blocks, in device order, on the model's device."""
        return [[t.to(device) for t in parts] for parts in zip(*outs)]

    def sharded_err(_params, x):
        errs, lows, highs = gathered(err_step(x))
        return torch.cat(errs), torch.stack(lows).amin(), torch.stack(highs).amax()

    def sharded_eval(_params, x, mu, sigma, emin, emax):
        return tuple(torch.cat(parts) for parts in
                     gathered(eval_step(x, mu, sigma, emin, emax)))

    return sharded_err, sharded_eval, place, score_params


def _scalar(value: float, device) -> torch.Tensor:
    """A float32 0-dim tensor on the device: CUDA's division by a Python
    scalar multiplies by its reciprocal, which rounds differently."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def get_data_scale(model, config: dict, data: dict, mesh=None, quantize=False,
                   score_params=None) -> dict:
    """The reference error distribution over the training split: meu,
    sigma, min and max of the per-pixel error, and the split's z-scores
    (zeros when sigma is 0)."""
    batch_err, _, place, score_params = _score_fns(
        model, mesh=mesh, quantize=quantize, score_params=score_params)
    err_list, mins, maxs = [], [], []
    for x in iter_images(data["train"]):
        x, n = place(x)
        err_reduced, emin, emax = batch_err(score_params, x)
        # one copy to the host a batch
        host = torch.cat([err_reduced, emin.view(1), emax.view(1)]).cpu().numpy()
        err_list.append(host[:n])
        mins.append(float(host[-2]))
        maxs.append(float(host[-1]))
    err_reduced = np.concatenate(err_list, axis=0)
    meu = float(np.mean(err_reduced))
    sigma = float(np.std(err_reduced))
    z_scores = (err_reduced - meu) / sigma if sigma > 0 else np.zeros_like(err_reduced)
    return {
        "meu": meu,
        "sigma": sigma,
        "min": float(np.min(mins)),
        "max": float(np.max(maxs)),
        "z_scores": z_scores,
    }


def evaluate_anomalies(
    model,
    config: dict,
    data: dict,
    data_scale: dict,
    anomaly_threshold: float,
    keep_maps: bool = True,
    artifact_path: str | None = None,
    num_workers: int = 8,
    mesh=None,
    quantize: bool = False,
    score_params=None,
) -> dict:
    """Score the evaluation split against the reference distribution.

    With ``artifact_path`` the five PNGs of each frame are written as each
    batch is scored (host memory stays O(batch)), and the result carries
    ``orig_paths``; ``keep_maps`` also returns every frame's reconstruction,
    error map and normalized error map. A degenerate reference (sigma 0, or
    max == min) divides by 1 instead: z = eps - meu and flat maps, never NaN.
    """
    _, batch_eval, place, score_params = _score_fns(
        model, mesh=mesh, quantize=quantize, score_params=score_params)
    device = torch.device(model.device)
    mu = _scalar(data_scale["meu"], device)
    sigma = _scalar(data_scale["sigma"] if data_scale["sigma"] > 0 else 1.0, device)
    emin = _scalar(data_scale["min"], device)
    span = data_scale["max"] - data_scale["min"]
    emax = _scalar(data_scale["min"] + (span if span > 0 else 1.0), device)

    sink = _ArtifactSink(artifact_path, num_workers) if artifact_path else None
    recs, errs, zs, norms = [], [], [], []
    idx = 0
    try:
        for x in iter_images(data["train"]):
            x, n = place(x)
            x_rec, err, z, norm_err = batch_eval(score_params, x, mu, sigma, emin, emax)
            zs.append(z[:n].cpu().numpy())
            if sink is not None:
                x_host, rec_host, norm_host = (t.cpu().numpy() for t in (x, x_rec, norm_err))
                for j in range(n):
                    sink.submit(idx, x_host[j], rec_host[j], norm_host[j])
                    idx += 1
            if keep_maps:
                recs.append(x_rec[:n].cpu().numpy())
                errs.append(err[:n].cpu().numpy())
                norms.append(norm_err[:n].cpu().numpy())
    except BaseException:
        if sink is not None:
            sink.pool.shutdown(cancel_futures=True)
        raise
    orig_paths = sink.close() if sink is not None else None
    z_scores = np.concatenate(zs, axis=0)
    anomalies = z_scores > anomaly_threshold
    print(f"anomalies: {np.sum(anomalies)} / {len(anomalies)} "
          f"({np.sum(anomalies) / max(len(anomalies), 1):.4f})")
    out = {"z_scores": z_scores, "anomalies": anomalies}
    if orig_paths is not None:
        out["orig_paths"] = orig_paths
    if keep_maps:
        out["rec"] = np.concatenate(recs, axis=0)
        out["errs"] = np.concatenate(errs, axis=0)
        out["norm_errs"] = np.concatenate(norms, axis=0)
    return out


def _artifact_dirs(output_path: str) -> dict:
    dirs = {name: os.path.join(output_path, name)
            for name in ("err", "heatmap", "overlay", "rec", "orig")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def _dump_frame(dirs: dict, i: int, x: np.ndarray, rec: np.ndarray,
                norm_err: np.ndarray) -> str:
    """Write the five PNGs of frame ``i`` ([0, 1] float x and rec, the
    normalized error map); returns the original's path, the key of
    ``anomaly_list.csv``. Single-channel frames (H, W, 1) are written as
    greyscale (``viz.plots.save_rgb``)."""
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import overlay_heatmap, save_rgb

    err_u8 = np.clip(np.round(255.0 * norm_err), 0, 255).astype(np.uint8)
    heatmap = jet_heatmap(err_u8)
    rec_u8 = np.clip(np.round(255.0 * rec), 0, 255).astype(np.uint8)
    orig_u8 = np.clip(np.round(255.0 * x), 0, 255).astype(np.uint8)
    overlay = overlay_heatmap(err_u8, rec_u8)
    basename = f"{i:06d}.png"
    save_rgb(err_u8, os.path.join(dirs["err"], basename))
    save_rgb(heatmap, os.path.join(dirs["heatmap"], basename))
    save_rgb(overlay, os.path.join(dirs["overlay"], basename))
    save_rgb(rec_u8, os.path.join(dirs["rec"], basename))
    orig_path = os.path.join(dirs["orig"], basename)
    save_rgb(orig_u8, orig_path)
    return orig_path


class _ArtifactSink:
    """Writes frames' artifacts through a thread pool with at most
    ``max_inflight`` frames waiting, so host memory stays O(batch)."""

    def __init__(self, output_path: str, num_workers: int = 8, max_inflight: int = 256):
        from collections import deque

        self.dirs = _artifact_dirs(output_path)
        self.pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        self.max_inflight = max_inflight
        self.pending = deque()
        self.paths: list = []

    def submit(self, i: int, x: np.ndarray, rec: np.ndarray, norm_err: np.ndarray):
        while len(self.pending) >= self.max_inflight:
            self.paths.append(self.pending.popleft().result())
        self.pending.append(self.pool.submit(_dump_frame, self.dirs, i, x, rec, norm_err))

    def close(self) -> list:
        """Wait for every write (a failed one raises here) and stop the pool."""
        try:
            while self.pending:
                self.paths.append(self.pending.popleft().result())
        finally:
            self.pool.shutdown(cancel_futures=True)
        return self.paths


def output_anomalies(
    evaluation_data: dict,
    anomaly_results: dict,
    data_scale: dict,
    output_path: str,
    anomaly_threshold: float,
    histogram_only: bool = False,
    num_workers: int = 8,
) -> None:
    """The z-score histogram (``anomaly_fig.png``), then, unless
    ``histogram_only``, the per-frame artifacts (already written when
    ``evaluate_anomalies`` had an ``artifact_path``) and ``anomaly_list.csv``
    sorted by z, highest first."""
    from trustedai_cl_vae_ad_tpu_torch.viz import plots

    if not os.path.isdir(output_path):
        raise NotADirectoryError(output_path)
    plots.histogram(
        os.path.join(output_path, "anomaly_fig.png"),
        {"Still Data": data_scale["z_scores"],
         "Evaluation Data": anomaly_results["z_scores"]},
        "Error Z-Score Histogram (Per Frame)",
        density=True,
        vline=anomaly_threshold,
        xlim=(-3.0, 70.0),
        log_y=True,
        xlabel="Z-Score (Normal Assumption)",
        ylabel="Density (Per Frame)",
    )
    if histogram_only:
        return

    if "orig_paths" in anomaly_results:
        orig_paths = anomaly_results["orig_paths"]
    else:
        scored = len(anomaly_results["z_scores"])
        dirs = _artifact_dirs(output_path)
        idx = 0
        with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
            futures = []
            for x_batch in iter_images(evaluation_data["train"]):
                if idx >= scored:
                    break
                for x in host_images(x_batch)[:scored - idx]:
                    futures.append(pool.submit(
                        _dump_frame, dirs, idx, x, anomaly_results["rec"][idx],
                        anomaly_results["norm_errs"][idx]))
                    idx += 1
            orig_paths = [f.result() for f in futures]

    rows = sorted(zip(orig_paths, anomaly_results["z_scores"][: len(orig_paths)]),
                  key=lambda t: t[1], reverse=True)
    with open(os.path.join(output_path, "anomaly_list.csv"), "w", newline="") as ofile:
        writer = csv.writer(ofile)
        writer.writerow(["orig_filepath", "z_score"])
        for row in rows:
            writer.writerow(row)
    print(f"Anomalies written out to: {output_path}")
