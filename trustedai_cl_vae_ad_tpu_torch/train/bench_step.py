"""The combined train + score step that the flagship benchmark times.

Counterpart of ``_flagship_config`` and the ``step`` of ``build_bench_step``
in the JAX package's ``bench.py``: one step is a gradient update (Adam) on a
batch of uint8 frames plus the per-frame anomaly z-scores from the
reconstruction error. This module is the step only; it times nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trustedai_cl_vae_ad_tpu_torch.models.wrapper import VAEModel


def flagship_config(latent: int = 2000) -> dict:
    """The flagship of configs/config.yml as the benchmark trains it."""
    return {
        "data": {"image_size": [224, 300, 3]},
        "loss": {
            "kurtosis": 1.8,
            "w_kl_divergence": 0.0,
            "w_kurtosis": 1e-4,
            "w_mse": 1.0,
            "w_skew": 0.0,
            "w_x_std": 0.0,
            "w_z_l1_reg": 0.0,
        },
        "model": {
            "type": "KurtosisGlobal",
            "latent_dimensions": latent,
            "layers": [32, 64],
            "decoder_dense_filters": 32,
        },
        "training": {
            "batch_size": 256,
            "beta": 0.98,
            "learning_rate": 1e-4,
            "max_epochs": 10,
        },
    }


def train_score_step(model: VAEModel, x_u8: torch.Tensor, mu, sigma,
                     eps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One combined step on a compiled model: normalize the uint8 frames,
    loss, backward, Adam update (in place), then per-frame z-scores
    ``(sum_hwc (x - x_hat)^2 - mu) / sigma`` against the training statistics.
    Returns (loss, z_scores (B,)) as device tensors, without waiting for the
    device."""
    x = x_u8.to(model.device).to(torch.float32) / 255.0
    loss_dict, x_hat = model.train_step_and_run(x, eps=eps)
    err = ((x - x_hat) ** 2).sum(dim=3)
    err_reduced = err.sum(dim=(1, 2))
    z_scores = (err_reduced - mu) / sigma
    return loss_dict["loss"], z_scores
