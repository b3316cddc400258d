"""KLGaussianCVAE: the Gaussian-ELBO variant with the analytic KL.

Counterpart of ``trustedai_cl_vae_ad_tpu/models/kl_gaussian.py``:

    loss = w_mse * MSE(x, x_hat) + w_kl_divergence * KL(q(z|x) || N(0, I))
    KL   = -0.5 * mean_batch sum_dims (1 + logvar - mean^2 - exp(logvar))

on the family's shared encoder and decoder, whose quirks (z = mean +
0.5*logvar + eps, the dead input-noise path, the sigmoid decode) apply here
too: the type selects the loss only. The diagnostics (z_l1, x_std_loss,
r_min, r_max) are computed, but only mse and kl_div are optimized. This loss
runs no hand-written kernel. ``compute_loss_chunked`` is not ported (see
``kurtosis_global.py``), and ``batch_group`` is that module's.
"""

from __future__ import annotations

from typing import Optional

import torch

from trustedai_cl_vae_ad_tpu_torch.models.batch_stats import (
    unweighted_image_stats,
    weighted_image_stats,
    weighted_z_l1,
)
from trustedai_cl_vae_ad_tpu_torch.models.cvae import AbstractCVAE, normalize_image_input
from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import gather_rows


class KLGaussianCVAE(AbstractCVAE):
    def __init__(self, config: dict, **kwargs):
        super().__init__(config, **kwargs)
        loss_config = self.config["loss"]
        self.w_mse = float(loss_config["w_mse"])
        self.w_kl_divergence = float(loss_config["w_kl_divergence"])

    @staticmethod
    def _kl_rows(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
        """Per-row analytic KL(N(mean, exp(logvar)) || N(0, 1)); shared by
        the unweighted (batch mean) and weighted paths."""
        return -0.5 * (1.0 + logvar - mean ** 2 - torch.exp(logvar)).sum(dim=1)

    @staticmethod
    def kl_divergence_gaussian(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
        """The analytic KL, mean over the batch: a true divergence
        (non-negative, zero iff the posterior is standard normal), not the
        global model's abs-KL diagnostic."""
        return KLGaussianCVAE._kl_rows(mean, logvar).mean()

    def compute_loss(self, x: torch.Tensor, training: bool = False, return_inf: bool = False,
                     eps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None, weights=None,
                     batch_group=None, detailed=None):
        """The 7-key metric dict (and x_hat with ``return_inf``); ``eps``,
        ``generator``, ``weights``, ``batch_group`` and ``detailed`` as in
        ``KurtosisGlobalCVAE.compute_loss``."""
        x = normalize_image_input(x)
        if detailed is None:
            detailed = self.call_detailed(x, training=training, eps=eps, generator=generator)
        x_hat_prob, z, mean, logvar = detailed
        if batch_group is not None:
            z, mean, logvar = (gather_rows(t, batch_group) for t in (z, mean, logvar))

        if weights is None:
            st = unweighted_image_stats(x, x_hat_prob, group=batch_group)
            kl_div = self.kl_divergence_gaussian(mean, logvar)
            z_l1_reg = z.abs().mean()
        else:
            st = weighted_image_stats(x, x_hat_prob, weights, group=batch_group)
            w = st["w"] if batch_group is None else gather_rows(st["w"], batch_group)
            kl_div = (w * self._kl_rows(mean, logvar)).sum() / st["wsum"]
            z_l1_reg = weighted_z_l1(z, w, st["wsum"])

        loss = self.w_mse * st["mse"] + self.w_kl_divergence * kl_div

        d = {
            "loss": loss,
            "mse": st["mse"],
            "kl_div": kl_div,
            "z_l1": z_l1_reg,
            "r_min": st["r_min"],
            "r_max": st["r_max"],
            "x_std_loss": st["x_std_loss"],
        }
        if return_inf:
            return d, x_hat_prob
        return d
