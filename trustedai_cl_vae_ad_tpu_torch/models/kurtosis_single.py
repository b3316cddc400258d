"""KurtosisSingleCVAE: loss over per-latent-dimension statistics.

Counterpart of ``trustedai_cl_vae_ad_tpu/models/kurtosis_single.py``. The
statistics are taken per latent dimension (over the batch axis). Kept exactly:

  * kurtosis loss = mean((kurt - target)^2) and skew loss = mean(skew^2):
    squared errors, unlike the global model's absolute values;
  * the optimized regularizer is the L2 norm of the per-dimension latent
    means, z_l2 = sqrt(sum(z_meu^2)), but it is weighted by ``w_z_l1_reg``
    (the original's name mismatch). Its gradient is z_meu / z_l2, which is
    0/0 when every column mean is exactly 0 (an all-zero latent);
  * the reported 'z_kurtosis' is sqrt(mean(kurt^2));
  * ``jnp.std`` is the population standard deviation (correction = 0).

The moment reductions go through ``ops.moments.perdim_moments``: the
hand-written CUDA kernels on the card, the plain versions on the CPU.
``compute_loss_chunked`` is not ported (see ``kurtosis_global.py``), and
``batch_group`` is that module's: z is gathered, image-space sums summed.
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
from trustedai_cl_vae_ad_tpu_torch.ops.moments import perdim_moments, perdim_moments_weighted
from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import gather_rows


class KurtosisSingleCVAE(AbstractCVAE):
    def __init__(self, config: dict, **kwargs):
        super().__init__(config, **kwargs)
        loss_config = self.config["loss"]
        self.kurtosis_target = float(loss_config["kurtosis"])
        self.w_mse = float(loss_config["w_mse"])
        self.w_kurtosis = float(loss_config["w_kurtosis"])
        self.w_skew = float(loss_config["w_skew"])
        self.w_z_l1_reg = float(loss_config["w_z_l1_reg"])

    def compute_loss(self, x: torch.Tensor, training: bool = False, return_inf: bool = False,
                     eps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None, weights=None,
                     batch_group=None, detailed=None):
        """The 10-key metric dict (and x_hat with ``return_inf``); ``eps``,
        ``generator``, ``weights``, ``batch_group`` and ``detailed`` as in
        ``KurtosisGlobalCVAE.compute_loss``."""
        x = normalize_image_input(x)
        if detailed is None:
            detailed = self.call_detailed(x, training=training, eps=eps, generator=generator)
        x_hat_prob, z, _, _ = detailed
        if batch_group is not None:
            z = gather_rows(z, batch_group)

        if weights is None:
            st = unweighted_image_stats(x, x_hat_prob, group=batch_group)
            z_meu, _, z_skew, z_kurtosis = perdim_moments(z)
            z_l1_reg = z.abs().mean()
        else:
            st = weighted_image_stats(x, x_hat_prob, weights, group=batch_group)
            w = st["w"] if batch_group is None else gather_rows(st["w"], batch_group)
            z_meu, _, z_skew, z_kurtosis = perdim_moments_weighted(z, w)
            z_l1_reg = weighted_z_l1(z, w, st["wsum"])

        z_kurtosis_loss = ((z_kurtosis - self.kurtosis_target) ** 2).mean()
        z_skew_loss = (z_skew ** 2).mean()
        z_l2_reg = torch.sqrt((z_meu ** 2).sum())

        loss = (
            self.w_mse * st["mse"]
            + self.w_kurtosis * z_kurtosis_loss
            + self.w_skew * z_skew_loss
            + self.w_z_l1_reg * z_l2_reg  # the weight's name mismatch is kept
        )

        d = {
            "loss": loss,
            "mse": st["mse"],
            "z_l1": z_l1_reg,
            "z_l2": z_l2_reg,
            "skew_loss": z_skew_loss,
            "z_kurtosis_loss": z_kurtosis_loss,
            "z_kurtosis": torch.sqrt((z_kurtosis ** 2).mean()),
            "r_min": st["r_min"],
            "r_max": st["r_max"],
            "x_std_loss": st["x_std_loss"],
        }
        if return_inf:
            return d, x_hat_prob
        return d
