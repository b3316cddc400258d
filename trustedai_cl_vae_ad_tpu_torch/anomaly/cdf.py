"""Empirical-CDF anomaly thresholds for the stream engine.

Counterpart of ``CDFObject``, ``normal_ppf`` and ``threshold_from_cdf`` in
``trustedai_cl_vae_ad_tpu/anomaly/cdf.py`` (numpy only, as there): a
histogram CDF with searchsorted lookups, and the robust tail-extrapolated
threshold. ``BSTProb`` and the timing CLI are not ported; the stream does
not use them.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

ArrayLike = Union[Sequence, np.ndarray]


class CDFObject:
    """Histogram empirical CDF (``np.histogram`` with ``bins``, normalized
    to unit mass, cumulated)."""

    def __init__(self, x: ArrayLike, bins="auto"):
        self.bins = bins
        self.reset(x, bins)

    def reset(self, x, bins=None):
        self.x = np.asarray(x)
        if bins:
            self.bins = bins
        self.hist, self.bin_edges = np.histogram(self.x, bins=self.bins, density=True)
        s = np.sum(self.hist)
        self.hist = self.hist / (s if s > 0 else 1.0)
        self.bin_mid = (self.bin_edges[1:] + self.bin_edges[:-1]) / 2.0
        self.bin_width = np.mean(self.bin_edges[1:] - self.bin_edges[:-1])
        self.meu = float(np.dot(self.hist, self.bin_mid))
        self.cdf = np.cumsum(self.hist)

    def get_prob_by_value(self, x):
        """P(X <= x) from the histogram CDF (scalar or array); 0 below the
        first bin edge."""
        idx = np.clip(np.searchsorted(self.bin_edges[1:], x, side="left"), 0, len(self.cdf) - 1)
        out = np.where(np.asarray(x) < self.bin_edges[0], 0.0, self.cdf[idx])
        return float(out) if np.isscalar(x) else out

    def get_value_by_prob(self, p):
        """Smallest right bin edge whose CDF reaches p (scalar or array)."""
        idx = np.clip(np.searchsorted(self.cdf, p, side="left"), 0, len(self.cdf) - 1)
        out = self.bin_edges[1:][idx]
        return float(out) if np.isscalar(p) else out


def normal_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation,
    |rel err| < 1.15e-9)."""
    assert 0.0 < p < 1.0
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = np.sqrt(-2 * np.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        q = np.sqrt(-2 * np.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def threshold_from_cdf(cdf: CDFObject, quantile: float, robust: bool = True) -> float:
    """Anomaly threshold at ``quantile`` from a score CDF.

    ``robust=True`` extrapolates from the distribution's bulk, which a few
    anomaly scores in the history cannot move:

        thr = q50 + (z(quantile) / z(0.9)) * (q90 - q50)

    ``robust=False`` reads the raw empirical quantile.
    """
    if not robust:
        return float(cdf.get_value_by_prob(quantile))
    quantile = min(max(float(quantile), 1e-9), 1.0 - 1e-9)
    q50 = float(cdf.get_value_by_prob(0.5))
    q90 = float(cdf.get_value_by_prob(0.9))
    factor = normal_ppf(quantile) / normal_ppf(0.9)
    return q50 + factor * max(q90 - q50, 0.0)
