"""The latent-space math of the latent tools, on the device.

Counterpart of the numpy and scikit-learn computations inside the JAX
package's ``similarity_analysis.py`` and ``plot_umap.py``:

  * ``latent_moments`` and ``standardize``: each latent column's mean, std
    and kurtosis over the batch, and the z-scores with a std of 0 replaced by
    1, from one call of ``ops/moments.py::perdim_moments_packed`` (kernel 3's
    forward on a CUDA tensor, its plain version on a CPU tensor). Kernel 3
    computes what the tools computed in numpy: population variance, z-scores
    that are 0 where the std is 0, and E[z_score^4];
  * ``pairwise_distances`` with scikit-learn's semantics for ``euclidean``
    and ``cosine``, computed in float64 and returned as float32, as
    scikit-learn returns them for float32 input;
  * ``PCAEmbedder``: an exact 2-D PCA (centre, SVD in float64, the signs
    fixed as scikit-learn >= 1.5 fixes them) with the UMAP surface
    ``fit / transform / inverse_transform`` on host arrays.

Nothing here imports scikit-learn, which the card's machine lacks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.ops.moments import perdim_moments_packed

METRICS = ("euclidean", "cosine")


def latent_moments(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, std, kurtosis) of each column of the (N, L) latents z, each
    (L,) float32 on z's device; std = sqrt(population variance)."""
    moments = perdim_moments_packed(z.to(torch.float32).contiguous())
    return moments[0], torch.sqrt(moments[1]), moments[3]


def standardize(z: torch.Tensor, moments=None):
    """(z_scores, mean, std_safe) of the (N, L) latents z: z_scores =
    (z - mean) / std_safe, where std_safe is the columns' std with 0 replaced
    by 1. ``moments``: ``latent_moments(z)`` when the caller has it."""
    mean, std, _kurt = latent_moments(z) if moments is None else moments
    std_safe = torch.where(std == 0, torch.ones_like(std), std)
    return (z.to(torch.float32) - mean) / std_safe, mean, std_safe


def pairwise_distances(x: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """(N, N) distances between the rows of x, with
    ``sklearn.metrics.pairwise_distances(x, metric=metric)``'s semantics:
    computed in float64 on x's device and returned as float32; the diagonal
    exactly 0; cosine distance 1 - cos clipped to [0, 2], a zero row at
    distance 1 from every other row. Euclidean distances are differences
    summed directly (no |x|^2 - 2xy + |y|^2), so near-duplicate rows keep
    their small distances."""
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    a = x.to(torch.float64)
    if metric == "euclidean":
        d = torch.cdist(a, a, compute_mode="donot_use_mm_for_euclid_dist")
    else:
        norm = torch.linalg.vector_norm(a, dim=1, keepdim=True)
        unit = a / torch.where(norm == 0, torch.ones_like(norm), norm)
        d = torch.clamp(1.0 - unit @ unit.T, 0.0, 2.0)
    d.fill_diagonal_(0.0)
    return d.to(torch.float32)


class PCAEmbedder:
    """Exact PCA onto ``n_components`` axes with the UMAP surface: ``fit``,
    ``transform`` and ``inverse_transform`` take and return host arrays
    (float32 in, float32 out), and compute in float64 on ``device``. The
    components are ``sklearn.decomposition.PCA(svd_solver="full")``'s:
    the rows of Vt of the centred data's SVD, each signed so that its entry
    of largest magnitude is positive."""

    def __init__(self, n_components: int = 2, device="cuda"):
        self.n_components = int(n_components)
        self.device = torch.device(device)
        self._mean: Optional[torch.Tensor] = None
        self._components: Optional[torch.Tensor] = None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, torch.float64)

    @staticmethod
    def _host(t: torch.Tensor, like) -> np.ndarray:
        out = t.cpu().numpy()
        return out.astype(np.float32) if np.asarray(like).dtype == np.float32 else out

    @property
    def components_(self) -> np.ndarray:
        return self._components.cpu().numpy()

    def fit(self, z) -> "PCAEmbedder":
        x = self._tensor(z)
        if not 0 < self.n_components <= min(x.shape):
            raise ValueError(f"n_components={self.n_components} must be in "
                             f"[1, {min(x.shape)}] for data of shape {tuple(x.shape)}")
        self._mean = x.mean(dim=0)
        _u, _s, vt = torch.linalg.svd(x - self._mean, full_matrices=False)
        vt = vt[: self.n_components]
        signs = torch.sign(vt.gather(1, vt.abs().argmax(dim=1, keepdim=True)))
        self._components = vt * signs
        return self

    def transform(self, z) -> np.ndarray:
        return self._host((self._tensor(z) - self._mean) @ self._components.T, z)

    def inverse_transform(self, e) -> np.ndarray:
        return self._host(self._tensor(e) @ self._components + self._mean, e)
