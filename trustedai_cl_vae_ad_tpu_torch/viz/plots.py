"""Plotting and rendering helpers of the artifact-producing surfaces.

Counterpart of ``trustedai_cl_vae_ad_tpu/viz/plots.py``: the JET heatmap of an
error map, its 50/50 overlay on a base image and PNG writes, which the live
engines' recorders use, and the figures of the evaluation and latent tools:
image grids (plain and labelled), histograms (alone or as panels of one
page), bars and scatter plots. The figures are drawn with PIL, so no surface
of the port needs matplotlib; it is imported only by ``jet_heatmap`` where
cv2 is missing.
"""

from __future__ import annotations

import functools
import threading
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
#: a plot's page, (width, height)
_PANEL = (640, 480)


def _font(size: int):
    from PIL import ImageFont

    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # PIL before 10.1: one bitmap size
        return ImageFont.load_default()


_GLYPH_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _glyph(ch: str, size: int):
    """(mask, advance) of one character: its rendering as an "L" image drawn
    at the origin of a line, and its advance in pixels."""
    from PIL import Image, ImageDraw

    with _GLYPH_LOCK:  # one FreeType face is shared by every thread
        font = _font(size)
        bottom = font.getbbox("Ag" + ch)[3]  # a line's depth, whatever the character
        mask = Image.new("L", (max(1, int(np.ceil(font.getbbox(ch)[2])) + 1),
                               max(1, int(np.ceil(bottom)) + 1)), 0)
        ImageDraw.Draw(mask).text((0, 0), ch, fill=255, font=font)
        return mask, font.getlength(ch)


def _text(img, xy, text: str, size: int = 12) -> None:
    """Black ``text`` (lines split at newlines) at ``xy`` of a PIL image,
    pasted glyph by glyph from a cache: the figures write thousands of labels
    (a histogram a latent column), and rendering each string anew holds the
    interpreter lock for a millisecond or more."""
    x0, y = float(xy[0]), int(round(float(xy[1])))
    for line in str(text).split("\n"):
        x = x0
        for ch in line:
            mask, advance = _glyph(ch, size)
            img.paste(0, (int(round(x)), y), mask)
            x += advance
        y += int(round(size * 1.25))


def _to_u8(img: np.ndarray) -> np.ndarray:
    """A [0, 1] float image (H, W), (H, W, 1) or (H, W, 3), clipped, as uint8
    grey or RGB."""
    arr = np.clip(np.asarray(img, np.float64), 0.0, 1.0)
    u8 = np.round(255.0 * arr).astype(np.uint8)
    return u8[..., 0] if u8.ndim == 3 and u8.shape[-1] == 1 else u8


def _tile(img: np.ndarray, size):
    """An RGB PIL tile of a [0, 1] image, scaled to ``size`` (w, h) by nearest neighbour."""
    from PIL import Image

    return Image.fromarray(_to_u8(img)).convert("RGB").resize(size, Image.NEAREST)


def _title_height(title: Optional[str], line: int = 18) -> int:
    return 12 + line * (title.count("\n") + 1) if title else 0


def image_grid(images: Sequence[np.ndarray], path: str, title: str, cols: int = 5) -> None:
    """Facet grid of [0, 1] float images, saved to ``path``: each image
    clipped to [0, 1], scaled up by an integer factor to at least 128 pixels
    a side, on a white page under the title."""
    from PIL import Image

    rows = max(1, int(np.ceil(len(images) / cols)))
    h, w = (np.asarray(images[0]).shape[:2] if len(images) else (1, 1))
    scale = max(1, int(np.ceil(128 / max(h, w))))
    cell_h, cell_w, pad, head = h * scale, w * scale, 8, 32
    page = Image.new("RGB", (cols * (cell_w + pad) + pad, head + rows * (cell_h + pad)), "white")
    for idx, img in enumerate(images):
        page.paste(_tile(img, (cell_w, cell_h)), (pad + (idx % cols) * (cell_w + pad),
                                                   head + (idx // cols) * (cell_h + pad)))
    _text(page, (pad, 8), title, 16)
    page.save(path)


def labelled_grid(cells: Sequence[Sequence], path: str, title: Optional[str] = None) -> None:
    """A grid of [0, 1] float images with optional labels, saved to ``path``.
    ``cells`` is a list of rows; a cell is ``None`` (left blank), an image, or
    ``(image, label)`` with the label written above the image. Every image is
    drawn at the size of the first one, scaled up by a whole factor to at
    least 64 pixels a side; a row with a label gets a band for it. The
    interpolation grid, the latent sample grid and the J-diagram are its
    layouts."""
    from PIL import Image

    rows = [[c if c is None or isinstance(c, tuple) else (c, None) for c in row]
            for row in cells]
    first = next(np.asarray(c[0]) for row in rows for c in row if c is not None)
    h, w = first.shape[:2]
    scale = max(1, int(np.ceil(64 / max(h, w))))
    cell_h, cell_w, pad = h * scale, w * scale, 4
    bands = [16 if any(c is not None and c[1] for c in row) else 0 for row in rows]
    head = _title_height(title)
    cols = max(len(row) for row in rows)
    page = Image.new("RGB", (pad + cols * (cell_w + pad),
                             head + pad + sum(bands) + len(rows) * (cell_h + pad)), "white")
    y = head + pad
    for row, band in zip(rows, bands):
        for j, cell in enumerate(row):
            if cell is None:
                continue
            img, label = cell
            x = pad + j * (cell_w + pad)
            if label:
                _text(page, (x, y + 1), str(label))
            page.paste(_tile(img, (cell_w, cell_h)), (x, y + band))
        y += band + cell_h + pad
    if title:
        _text(page, (pad + 4, 6), title, 16)
    page.save(path)


class _Axes:
    """The plot area of a panel: data coordinates to pixels, the frame, the
    axis ends and the labels."""

    def __init__(self, size, title, x_range, y_range, left=80, right=20, bottom=60):
        self.width, self.height = size
        self.left, self.top = left, 28 + _title_height(title)
        self.pw, self.ph = self.width - left - right, self.height - self.top - bottom
        self.title = title
        self.x0, self.x1 = x_range
        self.y0, self.y1 = y_range

    def px(self, x):
        return self.left + (np.clip(x, self.x0, self.x1) - self.x0) / (self.x1 - self.x0) * self.pw

    def py(self, y):
        return (self.top + self.ph
                - (np.clip(y, self.y0, self.y1) - self.y0) / (self.y1 - self.y0) * self.ph)

    def decorate(self, img, xlabel=None, ylabel=None, y_ends=None, grid=False):
        from PIL import ImageDraw

        draw = ImageDraw.Draw(img)
        left, top, pw, ph = self.left, self.top, self.pw, self.ph
        if grid:
            for k in range(1, 5):
                gx, gy = left + k * pw / 5, top + k * ph / 5
                draw.line([gx, top, gx, top + ph], fill=(220, 220, 220))
                draw.line([left, gy, left + pw, gy], fill=(220, 220, 220))
        draw.rectangle([left, top, left + pw, top + ph], outline="black")
        _text(img, (left, top + ph + 4), f"{self.x0:.4g}")
        _text(img, (left + pw - 40, top + ph + 4), f"{self.x1:.4g}")
        lo, hi = y_ends if y_ends is not None else (f"{self.y0:.3g}", f"{self.y1:.3g}")
        _text(img, (4, top + ph - 12), lo)
        _text(img, (4, top), hi)
        if xlabel:
            _text(img, (left + pw // 2 - 60, self.height - 24), xlabel)
        if ylabel:
            _text(img, (4, top + ph // 2), ylabel)
        if self.title:
            _text(img, (left, 12), self.title, 16)

    def legend(self, img, labels, alpha=255):
        from PIL import ImageDraw

        draw = ImageDraw.Draw(img)
        for k, label in enumerate(labels):
            y = self.top + 6 + 16 * k
            draw.rectangle([self.left + self.pw - 150, y, self.left + self.pw - 138, y + 10],
                           fill=_SERIES_RGB[k % len(_SERIES_RGB)] + (alpha,))
            _text(img, (self.left + self.pw - 132, y - 2), str(label))


def histogram_panel(
    series: Mapping[str, np.ndarray],
    title: str,
    bins="auto",
    log_y: bool = False,
    density: bool = False,
    xlabel: Optional[str] = None,
    ylabel: Optional[str] = None,
    vline: Optional[float] = None,
    xlim: Optional[tuple] = None,
    alpha: Optional[float] = None,
    legend: bool = True,
):
    """Overlaid histograms of ``series`` ({label: values}) as a PIL image:
    each series' bars (its own edges; ``bins="auto"`` is capped at 4096,
    ``_capped_auto_bins``) blended over the others with ``alpha`` (default
    0.65 for several series, opaque for one), the vertical line in red, the x
    range (``xlim``, else the series' edges) and y range written at the axes'
    ends, the labels, the title and, when ``legend`` and several series, a
    legend. All series are composited in one pass over one pixel array, bar
    by bar, so thousands of series (a latent matrix's columns) cost their
    bars, not a page each."""
    from PIL import Image, ImageDraw

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
    ax = _Axes(_PANEL, title, (x0, x1), (y0, y1))
    if alpha is None:
        alpha = 0.65 if len(hists) > 1 else 1.0
    img = Image.new("RGB", _PANEL, "white")
    draw = ImageDraw.Draw(img)
    # the plot area as floats, the bars blended into it in place (opaque bars: drawn)
    left, top, bottom = ax.left, ax.top, ax.top + ax.ph
    area = None if alpha >= 1.0 else np.full((ax.ph + 1, ax.pw + 1, 3), 255.0, np.float32)
    for k, (_label, counts, edges) in enumerate(hists):
        rgb = _SERIES_RGB[k % len(_SERIES_RGB)]
        keep = (counts > 0) & (edges[1:] >= x0) & (edges[:-1] <= x1)
        heights = np.log10(counts[keep]) if log_y else counts[keep]
        lefts = np.round(ax.px(edges[:-1][keep])).astype(int)
        rights = np.maximum(np.round(ax.px(edges[1:][keep])).astype(int), lefts + 1)
        tops = np.round(ax.py(heights)).astype(int)
        if area is None:
            for a, b, t in zip(lefts, rights, tops):
                draw.rectangle([a, t, b - 1, bottom], fill=rgb)
            continue
        colour = alpha * np.asarray(rgb, np.float32)
        for a, b, t in zip(lefts - left, rights - left, tops - top):
            region = area[t:, a:b]
            region *= 1.0 - alpha
            region += colour
    if area is not None:
        img.paste(Image.fromarray(np.round(area).astype(np.uint8)), (left, top))
    if vline is not None and x0 <= vline <= x1:
        draw.line([ax.px(vline), ax.top, ax.px(vline), ax.top + ax.ph], fill=(214, 39, 40),
                  width=2)
    ends = None
    if log_y:
        ends = (f"{10 ** y0:.3g}", f"{10 ** y1:.3g} (log)")
    ax.decorate(img, xlabel, ylabel, y_ends=ends)
    if legend and len(hists) > 1:
        ax.legend(img, [label for label, _c, _e in hists], int(255 * alpha))
    return img


def histogram(path: str, series: Mapping[str, np.ndarray], title: str, **kwargs) -> None:
    """``histogram_panel`` of ``series`` (its keyword arguments), saved to ``path``."""
    histogram_panel(series, title, **kwargs).save(path)


def bar_panel(values: np.ndarray, title: str, hline: Optional[float] = None,
              hline_label: Optional[str] = None):
    """One bar a value (at its index), a dashed horizontal line at ``hline``
    labelled ``hline_label``, as a PIL image."""
    from PIL import Image, ImageDraw

    values = np.asarray(values, np.float64).reshape(-1)
    finite = values[np.isfinite(values)]
    top = max([0.0, *finite.tolist(), *([hline] if hline is not None else [])])
    low = min([0.0, *finite.tolist()])
    ax = _Axes(_PANEL, title, (-0.5, len(values) - 0.5),
               (low, top * 1.05 if top > low else low + 1))
    img = Image.new("RGB", _PANEL, "white")
    draw = ImageDraw.Draw(img)
    for i, v in enumerate(values):
        if np.isfinite(v):
            draw.rectangle([ax.px(i - 0.45), ax.py(max(v, 0.0)), ax.px(i + 0.45),
                            ax.py(min(v, 0.0))], fill=_SERIES_RGB[0])
    if hline is not None:
        y = ax.py(hline)
        for x in np.arange(ax.left, ax.left + ax.pw, 12):
            draw.line([x, y, min(x + 6, ax.left + ax.pw), y], fill="black", width=2)
        if hline_label:
            _text(img, (ax.left + ax.pw - 150, y - 16), hline_label)
    ax.decorate(img)
    return img


def scatter(path: str, series: Mapping[str, np.ndarray], title: str) -> None:
    """Labelled point series ({label: (N, 2) points}) over a grid, with a
    legend and the axis ends written out, saved to ``path``."""
    from PIL import Image, ImageDraw

    pts = {label: np.asarray(p, np.float64).reshape(-1, 2) for label, p in series.items()}
    allp = np.concatenate([p for p in pts.values()] + [np.zeros((0, 2))])
    allp = allp[np.isfinite(allp).all(axis=1)]
    lo = allp.min(axis=0) if len(allp) else np.zeros(2)
    hi = allp.max(axis=0) if len(allp) else np.ones(2)
    span = np.where(hi > lo, hi - lo, 1.0)
    lo, hi = lo - 0.05 * span, hi + 0.05 * span
    ax = _Axes(_PANEL, title, (lo[0], hi[0]), (lo[1], hi[1]))
    img = Image.new("RGB", _PANEL, "white")
    draw = ImageDraw.Draw(img)
    ax.decorate(img, grid=True)
    for k, p in enumerate(pts.values()):
        colour = _SERIES_RGB[k % len(_SERIES_RGB)]
        for x, y in zip(ax.px(p[:, 0]), ax.py(p[:, 1])):
            draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill=colour)
    ax.legend(img, list(pts))
    img.save(path)


def panels(images: Sequence, path: str, title: Optional[str] = None, cols: int = 2) -> None:
    """PIL images (``histogram_panel``, ``bar_panel``) side by side, ``cols``
    a row, under a title, saved to ``path``."""
    from PIL import Image

    cols = max(1, min(cols, len(images)))
    rows = int(np.ceil(len(images) / cols))
    w = max(im.size[0] for im in images)
    h = max(im.size[1] for im in images)
    head = _title_height(title)
    page = Image.new("RGB", (cols * w, head + rows * h), "white")
    for k, im in enumerate(images):
        page.paste(im.convert("RGB"), ((k % cols) * w, head + (k // cols) * h))
    if title:
        _text(page, (12, 6), title, 16)
    page.save(path)
