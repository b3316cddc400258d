"""The plain reference of the live scorer: one update of K streams' per-pixel EMA state.

Written from the TF original's live scoring block, as the JAX package and its port
describe it, in plain PyTorch and float32, batched over the streams:

  * err = sum over channels of (x - x_hat)^2, a map a frame;
  * EMAs of the frame's min and max err -> the normalised error map;
  * per-pixel EMAs of err and err^2, seeded from the first frame -> z-scores
    (err - ema) / sqrt(|ema2 - ema^2| + 1e-10);
  * those standardized over the frame, the pixels above 3 counted;
  * EMAs of the count and its square -> score = (count - ema) / sqrt(ema2 - ema^2), NaN
    where that variance is 0 or below.

State: maps (K, 2, H, W) = [err_ema, err_sq_ema]; scalars (K, 6) = [min_ema, max_ema,
count_ema, count_sq_ema, initialized, 0].
"""

from __future__ import annotations

import torch


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """A map in [0, 1] as the grey levels the engine hands out."""
    return torch.clamp(torch.round(255.0 * x), 0, 255).to(torch.uint8)


def init_state(k: int, h: int, w: int, device):
    return (torch.zeros((k, 2, h, w), dtype=torch.float32, device=device),
            torch.zeros((k, 6), dtype=torch.float32, device=device))


def score_step(maps: torch.Tensor, scalars: torch.Tensor, img: torch.Tensor,
               rec: torch.Tensor, alpha: float):
    """One update of every stream (all valid). img, rec (K, H, W, C) in [0, 1].
    Returns (maps, scalars, norm (K, H, W), score (K,), count (K,))."""
    a = torch.tensor(alpha, dtype=torch.float32, device=img.device)
    oma = 1.0 - a
    d = img - rec
    err = d[..., 0] * d[..., 0]
    for ch in range(1, img.shape[-1]):
        err = err + d[..., ch] * d[..., ch]
    k = err.shape[0]
    flat = err.reshape(k, -1)
    initialized = (scalars[:, 4] > 0)[:, None, None]
    min_ema = a * scalars[:, 0] + oma * flat.min(dim=1).values
    max_ema = a * scalars[:, 1] + oma * flat.max(dim=1).values
    denom = max_ema - min_ema
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    norm = (err - min_ema[:, None, None]) / denom[:, None, None]

    prev = torch.where(initialized, maps[:, 0], err)
    prev2 = torch.where(initialized, maps[:, 1], err * err)
    ema = a * prev + oma * err
    ema2 = a * prev2 + oma * err * err
    z = (err - ema) * torch.reciprocal(torch.sqrt(torch.abs(ema2 - ema * ema) + 1e-10))

    n = float(z[0].numel())
    zc = z - (z.reshape(k, -1).sum(dim=1) / n)[:, None, None]
    std = torch.sqrt((zc * zc).reshape(k, -1).sum(dim=1) / n)
    zz = zc / torch.where(std == 0, torch.ones_like(std), std)[:, None, None]
    count = (zz > 3.0).reshape(k, -1).sum(dim=1).to(torch.float32)

    c_ema = a * scalars[:, 2] + oma * count
    c_ema2 = a * scalars[:, 3] + oma * count * count
    score = (count - c_ema) / torch.sqrt(c_ema2 - c_ema * c_ema)
    ones = torch.ones_like(count)
    new_scalars = torch.stack([min_ema, max_ema, c_ema, c_ema2, ones, torch.zeros_like(ones)],
                              dim=1)
    return torch.stack([ema, ema2], dim=1), new_scalars, norm, score, count
