"""Plotting and rendering helpers of the artifact-producing surfaces.

Counterpart of ``trustedai_cl_vae_ad_tpu/viz/plots.py``: the JET heatmap of an
error map, its 50/50 overlay on a base image and PNG writes, which the live
engines' recorders use, and the image grid and histogram figures of the
evaluation tools. matplotlib is imported lazily with the agg backend, inside
the functions that need it, so nothing on the recording path loads it when
cv2 is present.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    return plt


def jet_heatmap(err_u8: np.ndarray) -> np.ndarray:
    """JET colormap of a uint8 map, as RGB uint8: cv2's ``COLORMAP_JET``
    when cv2 is importable, else matplotlib's jet."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        bgr = cv2.applyColorMap(err_u8, cv2.COLORMAP_JET)
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    import matplotlib.cm as cm

    return (cm.jet(err_u8.astype(np.float32) / 255.0)[..., :3] * 255).astype(np.uint8)


def image_grid(images: Sequence[np.ndarray], path: str, title: str, cols: int = 5) -> None:
    """Facet grid of [0, 1] float images, saved to ``path``."""
    plt = _plt()
    rows = int(np.ceil(len(images) / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    for idx in range(rows * cols):
        ax = axes[idx // cols][idx % cols]
        ax.axis("off")
        if idx < len(images):
            img = np.clip(images[idx], 0.0, 1.0)
            ax.imshow(img if img.shape[-1] != 1 else img[..., 0])
    fig.suptitle(title)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def _capped_auto_bins(flat: np.ndarray, cap: int = 4096) -> int:
    """numpy's "auto" bin count (the larger of Freedman-Diaconis and
    Sturges), computed without making the edges, capped at ``cap``: on
    heavy-tailed data (z-scores of a near-degenerate sigma reach 1e9 while
    the bulk's IQR stays near 1) Freedman-Diaconis asks for billions of
    bins, and allocating their edges raises MemoryError."""
    finite = flat[np.isfinite(flat)]
    n = finite.size
    if n < 2:
        return 10
    lo, hi = float(finite.min()), float(finite.max())
    if hi <= lo:
        return 10
    sturges = int(np.ceil(np.log2(n))) + 1
    q75, q25 = np.percentile(finite, [75, 25])
    fd_width = 2.0 * float(q75 - q25) / n ** (1.0 / 3.0)
    fd = int(np.ceil((hi - lo) / fd_width)) if fd_width > 0 else sturges
    return max(1, min(cap, max(fd, sturges)))


def histogram(
    path: str,
    series: Mapping[str, np.ndarray],
    title: str,
    bins="auto",
    log_y: bool = False,
    density: bool = False,
    xlabel: Optional[str] = None,
    ylabel: Optional[str] = None,
    vline: Optional[float] = None,
    xlim: Optional[tuple] = None,
) -> None:
    """Overlaid histograms of ``series`` ({label: values}), saved to
    ``path``; ``bins="auto"`` is capped at 4096 (``_capped_auto_bins``)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1)
    alpha = 0.65 if len(series) > 1 else 1.0
    for label, values in series.items():
        flat = np.asarray(values).reshape(-1)
        b = _capped_auto_bins(flat) if bins == "auto" else bins
        ax.hist(flat, bins=b, label=label, alpha=alpha, density=density)
    if vline is not None:
        ax.axvline(vline, color="red", alpha=0.85)
    if xlim is not None:
        ax.set_xlim(*xlim)
    if log_y:
        ax.set_yscale("log")
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid()
    if len(series) > 1:
        ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def save_rgb(arr_u8: np.ndarray, path: str) -> None:
    """PNG write of an RGB (H, W, 3) or grayscale (H, W) / (H, W, 1) uint8
    array. PIL builds no image from (H, W, 1), which single-channel models
    produce, so that shape is squeezed to grayscale ("L")."""
    from PIL import Image

    if arr_u8.ndim == 3 and arr_u8.shape[-1] == 1:
        arr_u8 = arr_u8[..., 0]
    mode = "L" if arr_u8.ndim == 2 else "RGB"
    Image.fromarray(arr_u8, mode=mode).save(path)


def overlay_heatmap(norm_err_u8: np.ndarray, base_u8: np.ndarray) -> np.ndarray:
    """50/50 blend of the JET heatmap of an error map over a base image; the
    caller picks the base (the live recorder: the model-size input frame)."""
    heat = jet_heatmap(norm_err_u8)
    return (0.5 * heat + 0.5 * base_u8).astype(np.uint8)
