"""Plotting and rendering helpers of the artifact-producing surfaces.

Counterpart of ``trustedai_cl_vae_ad_tpu/viz/plots.py``: the JET heatmap of an
error map, its 50/50 overlay on a base image and PNG writes, which the live
engines' recorders use, and the image grid and histogram figures of the
evaluation tools. The two figures are drawn with PIL, so no surface of the
port needs matplotlib; it is imported only by ``jet_heatmap`` where cv2 is
missing.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np


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


# -- the figures --------------------------------------------------------------------------

#: the series' colours (matplotlib's tab10, as the JAX package's figures have them)
_SERIES_RGB = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (148, 103, 189)]


def _font(size: int):
    from PIL import ImageFont

    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # PIL before 10.1: one bitmap size
        return ImageFont.load_default()


def image_grid(images: Sequence[np.ndarray], path: str, title: str, cols: int = 5) -> None:
    """Facet grid of [0, 1] float images, saved to ``path``: each image
    clipped to [0, 1], scaled up by an integer factor to at least 128 pixels
    a side, on a white page under the title."""
    from PIL import Image, ImageDraw

    rows = max(1, int(np.ceil(len(images) / cols)))
    h, w = (np.asarray(images[0]).shape[:2] if len(images) else (1, 1))
    scale = max(1, int(np.ceil(128 / max(h, w))))
    cell_h, cell_w, pad, head = h * scale, w * scale, 8, 32
    page = Image.new("RGB", (cols * (cell_w + pad) + pad, head + rows * (cell_h + pad)), "white")
    for idx, img in enumerate(images):
        arr = np.clip(np.asarray(img, np.float64), 0.0, 1.0)
        u8 = np.round(255.0 * arr).astype(np.uint8)
        if u8.ndim == 3 and u8.shape[-1] == 1:
            u8 = u8[..., 0]
        tile = Image.fromarray(u8).convert("RGB").resize((cell_w, cell_h), Image.NEAREST)
        page.paste(tile, (pad + (idx % cols) * (cell_w + pad),
                          head + (idx // cols) * (cell_h + pad)))
    ImageDraw.Draw(page).text((pad, 8), title, fill="black", font=_font(16))
    page.save(path)


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
    ``path``: each series' bars (its own edges; ``bins="auto"`` is capped at
    4096, ``_capped_auto_bins``) blended over the others, the vertical line
    in red, the x range (``xlim``, else the series' edges) and y range
    written at the axes' ends, the labels, the title and a legend."""
    from PIL import Image, ImageDraw

    width, height, left, right, top, bottom = 640, 480, 80, 20, 40, 60
    hists = []
    for label, values in series.items():
        flat = np.asarray(values, np.float64).reshape(-1)
        flat = flat[np.isfinite(flat)]
        b = _capped_auto_bins(flat) if bins == "auto" else bins
        if flat.size:
            counts, edges = np.histogram(flat, bins=b, density=density)
        else:
            counts, edges = np.zeros(1), np.array([0.0, 1.0])
        hists.append((label, counts.astype(np.float64), edges))
    x0, x1 = xlim if xlim is not None else (min(e[0] for _l, _c, e in hists),
                                            max(e[-1] for _l, _c, e in hists))
    if not x1 > x0:
        x0, x1 = x0 - 0.5, x0 + 0.5
    positive = np.concatenate([c[c > 0] for _l, c, _e in hists] + [np.ones(0)])
    if log_y:
        lo = float(positive.min()) if positive.size else 1.0
        y0, y1 = np.log10(lo) - 0.1, np.log10(float(positive.max()) if positive.size else 10.0)
    else:
        y0, y1 = 0.0, float(positive.max()) if positive.size else 1.0
    if not y1 > y0:
        y1 = y0 + 1.0
    pw, ph = width - left - right, height - top - bottom

    def px(x):
        return left + (np.clip(x, x0, x1) - x0) / (x1 - x0) * pw

    def py(y):
        return top + ph - (np.clip(y, y0, y1) - y0) / (y1 - y0) * ph

    page = Image.new("RGBA", (width, height), (255, 255, 255, 255))
    alpha = int(255 * (0.65 if len(hists) > 1 else 1.0))
    for k, (_label, counts, edges) in enumerate(hists):
        layer = Image.new("RGBA", page.size, (0, 0, 0, 0))
        draw = ImageDraw.Draw(layer)
        colour = _SERIES_RGB[k % len(_SERIES_RGB)] + (alpha,)
        for c, a, b in zip(counts, edges[:-1], edges[1:]):
            if c <= 0 or b < x0 or a > x1:
                continue
            y = np.log10(c) if log_y else c
            draw.rectangle([px(a), py(y), max(px(b), px(a) + 1), py(y0)], fill=colour)
        page = Image.alpha_composite(page, layer)
    draw = ImageDraw.Draw(page)
    font = _font(12)
    draw.rectangle([left, top, left + pw, top + ph], outline="black")
    if vline is not None and x0 <= vline <= x1:
        draw.line([px(vline), top, px(vline), top + ph], fill=(214, 39, 40, 217), width=2)
    draw.text((left, top + ph + 4), f"{x0:.4g}", fill="black", font=font)
    draw.text((left + pw - 40, top + ph + 4), f"{x1:.4g}", fill="black", font=font)
    ends = (10 ** y0, 10 ** y1) if log_y else (y0, y1)
    draw.text((4, top + ph - 12), f"{ends[0]:.3g}", fill="black", font=font)
    draw.text((4, top), f"{ends[1]:.3g}" + (" (log)" if log_y else ""), fill="black", font=font)
    if xlabel:
        draw.text((left + pw // 2 - 60, height - 24), xlabel, fill="black", font=font)
    if ylabel:
        draw.text((4, top + ph // 2), ylabel, fill="black", font=font)
    draw.text((left, 12), title, fill="black", font=_font(16))
    if len(hists) > 1:
        for k, (label, _c, _e) in enumerate(hists):
            y = top + 6 + 16 * k
            draw.rectangle([left + pw - 150, y, left + pw - 138, y + 10],
                           fill=_SERIES_RGB[k % len(_SERIES_RGB)] + (alpha,))
            draw.text((left + pw - 132, y - 2), str(label), fill="black", font=font)
    page.convert("RGB").save(path)
