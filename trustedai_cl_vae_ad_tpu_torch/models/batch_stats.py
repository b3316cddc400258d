"""Image-space statistics of the losses, plain and weighted (masked batch).

Counterpart of ``trustedai_cl_vae_ad_tpu/models/batch_stats.py``. A
fixed-capacity replay buffer pads batches with weight-0 rows; every batch
statistic must exclude them exactly, so that the masked loss equals the
unmasked loss on the valid rows.
"""

from __future__ import annotations

import torch


def unweighted_image_stats(x: torch.Tensor, x_hat_prob: torch.Tensor) -> dict:
    """mse, per-pixel std-matching loss (population std) and r_min / r_max of
    a whole batch: the terms the three loss families share."""
    x_std = torch.std(x, dim=0, correction=0)
    x_hat_std = torch.std(x_hat_prob, dim=0, correction=0)
    return {
        "mse": ((x - x_hat_prob) ** 2).mean(),
        "x_std_loss": ((x_std - x_hat_std) ** 2).mean(),
        "r_min": x_hat_prob.min(),
        "r_max": x_hat_prob.max(),
    }


def weighted_image_stats(x: torch.Tensor, x_hat_prob: torch.Tensor, weights) -> dict:
    """Weighted mse, per-pixel std-matching loss and masked r_min / r_max.

    Also returns the weight tensors (w, wx, wsum, n_el) for the terms of each
    loss family (cross-entropy, abs-KL, z_l1). All reductions are population
    (ddof = 0) over the weighted batch and equal the unweighted expressions
    when the weights are all ones.
    """
    w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
    wx = w[:, None, None, None]
    wsum = w.sum()
    n_el = wsum * (x.shape[1] * x.shape[2] * x.shape[3])

    mse = (wx * (x - x_hat_prob) ** 2).sum() / n_el

    x_wmean = (wx * x).sum(dim=0) / wsum
    x_std = torch.sqrt((wx * (x - x_wmean) ** 2).sum(dim=0) / wsum)
    xh_wmean = (wx * x_hat_prob).sum(dim=0) / wsum
    x_hat_std = torch.sqrt((wx * (x_hat_prob - xh_wmean) ** 2).sum(dim=0) / wsum)
    x_std_loss = ((x_std - x_hat_std) ** 2).mean()

    valid = wx > 0
    inf = torch.full_like(x_hat_prob, float("inf"))
    r_min = torch.where(valid, x_hat_prob, inf).min()
    r_max = torch.where(valid, x_hat_prob, -inf).max()
    return {
        "w": w, "wx": wx, "wsum": wsum, "n_el": n_el,
        "mse": mse, "x_std_loss": x_std_loss, "r_min": r_min, "r_max": r_max,
    }


def weighted_z_l1(z: torch.Tensor, w: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """Weighted mean |z| over the valid rows."""
    return (w[:, None] * z.abs()).sum() / (wsum * z.shape[1])
