"""Image-space statistics of the losses, plain and weighted (masked batch).

Counterpart of ``trustedai_cl_vae_ad_tpu/models/batch_stats.py``. A
fixed-capacity replay buffer pads batches with weight-0 rows; every batch
statistic must exclude them exactly, so that the masked loss equals the
unmasked loss on the valid rows.

With ``group`` (the data axis of a mesh) the statistics are those of the
global batch, every rank's rows together: partial sums are summed over the
group (``parallel/collectives.py``), the per-pixel std in two passes like
``torch.std``, the second centered on the global mean taken without gradient
(a population variance's gradient through its own mean is zero), and r_min /
r_max are a MIN and a MAX. Without it the code and the bits are one device's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import global_max, global_min, global_sum


def unweighted_image_stats(x: torch.Tensor, x_hat_prob: torch.Tensor, group=None) -> dict:
    """mse, per-pixel std-matching loss (population std) and r_min / r_max of
    a whole batch: the terms the three loss families share."""
    if group is not None:
        return _group_image_stats(x, x_hat_prob, None, group)
    x_std = torch.std(x, dim=0, correction=0)
    x_hat_std = torch.std(x_hat_prob, dim=0, correction=0)
    return {
        "mse": ((x - x_hat_prob) ** 2).mean(),
        "x_std_loss": ((x_std - x_hat_std) ** 2).mean(),
        "r_min": x_hat_prob.min(),
        "r_max": x_hat_prob.max(),
    }


def weighted_image_stats(x: torch.Tensor, x_hat_prob: torch.Tensor, weights,
                         group=None) -> dict:
    """Weighted mse, per-pixel std-matching loss and masked r_min / r_max.

    Also returns the weight tensors (w, wx, wsum, n_el) for the terms of each
    loss family (cross-entropy, abs-KL, z_l1). All reductions are population
    (ddof = 0) over the weighted batch and equal the unweighted expressions
    when the weights are all ones.
    """
    w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
    if group is not None:
        return _group_image_stats(x, x_hat_prob, w, group)
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


def _group_image_stats(x: torch.Tensor, x_hat_prob: torch.Tensor, w, group) -> dict:
    """The statistics of either function above over the global batch of
    ``group``; ``w`` None for the unweighted ones (then w, wx, wsum and n_el
    are not returned)."""
    pixels = x.shape[1] * x.shape[2] * x.shape[3]
    if w is None:
        wx = None
        wsum = torch.tensor(float(x.shape[0] * dist.get_world_size(group)), device=x.device)
    else:
        wx = w[:, None, None, None]
        wsum = global_sum(w.sum(), group)
    n_el = wsum * pixels

    def weighted(t):
        return t if wx is None else wx * t

    def pixel_std(t):
        mean = global_sum(weighted(t).sum(dim=0), group) / wsum
        centered = weighted((t - mean.detach()) ** 2).sum(dim=0)
        return torch.sqrt(global_sum(centered, group) / wsum)

    mse = global_sum(weighted((x - x_hat_prob) ** 2).sum(), group) / n_el
    x_std_loss = ((pixel_std(x) - pixel_std(x_hat_prob)) ** 2).mean()
    if wx is None:
        lo, hi = x_hat_prob.min(), x_hat_prob.max()
    else:
        inf = torch.full_like(x_hat_prob, float("inf"))
        lo = torch.where(wx > 0, x_hat_prob, inf).min()
        hi = torch.where(wx > 0, x_hat_prob, -inf).max()
    out = {"mse": mse, "x_std_loss": x_std_loss,
           "r_min": global_min(lo, group), "r_max": global_max(hi, group)}
    if w is not None:
        out.update(w=w, wx=wx, wsum=wsum, n_el=n_el)
    return out
