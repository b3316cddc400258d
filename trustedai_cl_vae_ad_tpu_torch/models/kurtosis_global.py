"""KurtosisGlobalCVAE: loss over the global scalar statistics of the latent.

Counterpart of ``trustedai_cl_vae_ad_tpu/models/kurtosis_global.py``. The
batch latents are treated as one flat distribution; the loss shapes its
global mean, variance, skew and kurtosis. Kept exactly:

  * the cross-entropy diagnostic is a softmax over the ENTIRE batch tensor;
  * the "abs-KL" diagnostic squares logvar:
    0.5 * sum(|1 + logvar^2 - mean^2 - exp(logvar^2)|);
  * z-scores use divide_no_nan (zero where std == 0);
  * optimized loss = w_mse*mse + w_kurtosis*|K_target - K| + w_skew*|skew|
    + w_z_l1*mean(|z|); the x_std, variance and mean terms are computed for
    the metric dict but not optimized;
  * ``jnp.std`` is the population standard deviation (correction = 0).

The moment reductions go through ``ops.moments.global_moments``: the
hand-written CUDA kernels on the card, the plain versions on the CPU.
``compute_loss_chunked`` is not ported: it exists for XLA's 2 GiB buffer
limit, and ``training.loss_chunks`` is accepted and ignored.

``batch_group`` (the data axis of a mesh, ``parallel/``) makes every batch
statistic that of the global batch: z, mean and logvar are gathered, so the
latent terms (the moments kernel among them) run on all ranks' rows, and the
image-space terms sum partial sums over the group.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from trustedai_cl_vae_ad_tpu_torch.models.batch_stats import (
    unweighted_image_stats,
    weighted_image_stats,
    weighted_z_l1,
)
from trustedai_cl_vae_ad_tpu_torch.models.cvae import AbstractCVAE, normalize_image_input
from trustedai_cl_vae_ad_tpu_torch.ops.moments import global_moments, global_moments_weighted
from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import gather_rows, global_sum


def _abs_kl_terms(z_mean: torch.Tensor, z_logvar: torch.Tensor) -> torch.Tensor:
    """Per-element terms of the "abs-KL" diagnostic (logvar is SQUARED, not
    the textbook form); shared by the unweighted and weighted paths."""
    return torch.abs(1.0 + z_logvar ** 2 - z_mean ** 2 - torch.exp(z_logvar ** 2))


class KurtosisGlobalCVAE(AbstractCVAE):
    def __init__(self, config: dict, **kwargs):
        super().__init__(config, **kwargs)
        loss_config = self.config["loss"]
        self.kurtosis_target = float(loss_config["kurtosis"])
        self.w_mse = float(loss_config["w_mse"])
        self.w_kurtosis = float(loss_config["w_kurtosis"])
        self.w_skew = float(loss_config["w_skew"])
        self.w_kl_divergence = float(loss_config["w_kl_divergence"])
        self.w_z_l1_reg = float(loss_config["w_z_l1_reg"])
        self.w_x_std = float(loss_config.get("w_x_std", 0.0))

    def kl_divergence_gaussian(self, z_mean: torch.Tensor, z_logvar: torch.Tensor) -> torch.Tensor:
        return 0.5 * _abs_kl_terms(z_mean, z_logvar).sum()

    def log_normal_pdf(self, sample, mean, logvar, raxis: int = 1) -> torch.Tensor:
        """Legacy ELBO helper."""
        log2pi = math.log(2.0 * math.pi)
        return torch.abs(torch.mean(
            -0.5 * (((sample - mean) ** 2.0) * torch.exp(-logvar) + logvar + log2pi), dim=raxis))

    def compute_loss(self, x: torch.Tensor, training: bool = False, return_inf: bool = False,
                     eps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None, weights=None,
                     batch_group=None, detailed=None):
        """The 12-key metric dict (and x_hat with ``return_inf``).

        ``weights`` (B,) optionally masks rows out of EVERY batch statistic
        (weight-0 rows contribute nothing); with all-ones weights this equals
        the unweighted path. ``eps`` injects the latent noise; when training
        without it, it is drawn from ``generator``. ``batch_group``: this
        rank's rows are a share of the global batch of that process group.
        ``detailed``: the forward's (x_hat_prob, z, mean, logvar) of x,
        computed elsewhere (the fleet engine's mesh, one device a block of
        rows); the loss is then taken over them and nothing runs the forward.
        """
        x = normalize_image_input(x)
        if detailed is None:
            detailed = self.call_detailed(x, training=training, eps=eps, generator=generator)
        x_hat_prob, z, mean, logvar = detailed
        if batch_group is not None:
            z, mean, logvar = (gather_rows(t, batch_group) for t in (z, mean, logvar))

        def batch_sum(t):
            return t if batch_group is None else global_sum(t, batch_group)

        if weights is None:
            # entropy diagnostic: softmax over the whole tensor
            if batch_group is None:
                x_logit = torch.log(torch.exp(x) / torch.exp(x).sum())
                likelihood_cross_entropy = -(x_hat_prob * x_logit).mean()
            else:
                x_logit = torch.log(torch.exp(x) / batch_sum(torch.exp(x).sum()))
                likelihood_cross_entropy = (-batch_sum((x_hat_prob * x_logit).sum())
                                            / (x.numel() * dist.get_world_size(batch_group)))

            st = unweighted_image_stats(x, x_hat_prob, group=batch_group)
            z_mean, z_var, z_skew, z_kurtosis = global_moments(z)
            kl_div_gaus = self.kl_divergence_gaussian(mean, logvar)
            z_l1_reg = z.abs().mean()
        else:
            st = weighted_image_stats(x, x_hat_prob, weights, group=batch_group)
            wx, wsum, n_el = st["wx"], st["wsum"], st["n_el"]
            w = st["w"] if batch_group is None else gather_rows(st["w"], batch_group)

            x_logit = torch.log(torch.exp(x) / batch_sum((wx * torch.exp(x)).sum()))
            likelihood_cross_entropy = -batch_sum((wx * x_hat_prob * x_logit).sum()) / n_el

            z_mean, z_var, z_skew, z_kurtosis = global_moments_weighted(z, w)

            kl_div_gaus = 0.5 * (w[:, None] * _abs_kl_terms(mean, logvar)).sum()
            z_l1_reg = weighted_z_l1(z, w, wsum)

        mse, x_std_loss = st["mse"], st["x_std_loss"]
        r_min, r_max = st["r_min"], st["r_max"]
        var_loss = torch.abs(1.0 - z_var)
        z_skew_loss = torch.abs(z_skew)
        z_kurtosis_loss = torch.abs(self.kurtosis_target - z_kurtosis)

        loss = (
            self.w_mse * mse
            + self.w_kurtosis * z_kurtosis_loss
            + self.w_skew * z_skew_loss
            + self.w_z_l1_reg * z_l1_reg
        )

        d = {
            "loss": loss,
            "mse": mse,
            "z_l1": z_l1_reg,
            "var_loss": var_loss,
            "skew_loss": z_skew_loss,
            "z_kurtosis_loss": z_kurtosis_loss,
            "z_kurtosis": z_kurtosis,
            "r_min": r_min,
            "r_max": r_max,
            "cross_entropy": likelihood_cross_entropy,
            "kl_div": kl_div_gaus,
            "x_std_loss": x_std_loss,
        }
        if return_inf:
            return d, x_hat_prob
        return d
