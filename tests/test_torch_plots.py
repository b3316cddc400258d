"""The port's viz/plots.py against the JAX package's viz/plots.py: the same
random uint8 maps give the same heatmaps, overlays and PNG bytes, bit for
bit; the figures are drawn with PIL and written, and matplotlib stays unloaded
on the recording path when cv2 is present."""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from trustedai_cl_vae_ad_tpu.viz import plots as jax_plots
from trustedai_cl_vae_ad_tpu_torch.viz import plots

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(8, 6), (37, 53), (224, 300)]


def _map(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_jet_heatmap_equals_jax(shape):
    err = _map(shape, 1)
    got = plots.jet_heatmap(err)
    assert got.dtype == np.uint8 and got.shape == (*shape, 3)
    np.testing.assert_array_equal(got, jax_plots.jet_heatmap(err))


def test_jet_heatmap_without_cv2_equals_jax(monkeypatch):
    """matplotlib's jet, where cv2 is missing, in both packages."""
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    err = _map((9, 11), 2)
    got = plots.jet_heatmap(err)
    np.testing.assert_array_equal(got, jax_plots.jet_heatmap(err))
    assert not np.array_equal(got, np.zeros_like(got))


@pytest.mark.parametrize("channels", [3, 1], ids=["rgb", "single"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_overlay_heatmap_equals_jax(shape, channels):
    err, base = _map(shape, 3), _map((*shape, channels), 4)
    got = plots.overlay_heatmap(err, base)
    assert got.shape == (*shape, 3)
    np.testing.assert_array_equal(got, jax_plots.overlay_heatmap(err, base))


@pytest.mark.parametrize("shape", [(8, 6), (8, 6, 1), (8, 6, 3), (37, 53, 3)],
                         ids=["gray", "hw1", "rgb", "rgb-ragged"])
def test_save_rgb_equals_jax(shape, tmp_path):
    arr = _map(shape, 5)
    plots.save_rgb(arr, str(tmp_path / "port.png"))
    jax_plots.save_rgb(arr, str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    with Image.open(tmp_path / "port.png") as img:
        assert img.mode == ("RGB" if shape[-1] == 3 and len(shape) == 3 else "L")
        np.testing.assert_array_equal(np.asarray(img), arr.reshape(np.asarray(img).shape))


@pytest.mark.parametrize("values", [np.random.RandomState(0).randn(1000),
                                    np.concatenate([np.random.RandomState(1).randn(500), [1e9]]),
                                    np.array([1.0]), np.full(10, 2.0)],
                         ids=["normal", "heavy-tail", "one", "constant"])
def test_capped_auto_bins_equals_jax(values):
    assert plots._capped_auto_bins(values) == jax_plots._capped_auto_bins(values)
    assert plots._capped_auto_bins(values) <= 4096


def test_figures_are_written(tmp_path):
    rng = np.random.RandomState(6)
    plots.image_grid([rng.rand(8, 8, 3), rng.rand(8, 8, 1)], str(tmp_path / "grid.png"), "grid",
                     cols=2)
    plots.histogram(str(tmp_path / "hist.png"), {"a": rng.randn(200), "b": rng.randn(200) + 1},
                    "hist", log_y=True, vline=0.5, xlim=(-3, 3), xlabel="x", ylabel="n")
    for name in ("grid.png", "hist.png"):
        with Image.open(tmp_path / name) as img:
            assert img.size[0] > 0 and img.size[1] > 0


def test_recording_helpers_do_not_load_matplotlib(tmp_path):
    """With cv2 present the recording path (heatmap, overlay, PNG writes)
    never imports matplotlib, which the card's machine may lack."""
    code = f"""
import sys, numpy as np
from trustedai_cl_vae_ad_tpu_torch.viz import plots
err = np.zeros((4, 5), np.uint8)
plots.save_rgb(plots.overlay_heatmap(err, np.zeros((4, 5, 3), np.uint8)), {str(tmp_path / 'o.png')!r})
print("matplotlib" in sys.modules)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "False"


def test_figures_without_matplotlib(tmp_path, monkeypatch):
    """Both figures are drawn with PIL, with matplotlib unimportable (a GPU
    host may lack it): the grid holds every image, scaled by a whole factor;
    the histogram has the series' bars and the red threshold line."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises ImportError
    rng = np.random.RandomState(7)
    images = [rng.rand(16, 12, 3) for _ in range(6)] + [rng.rand(16, 12, 1)]
    plots.image_grid(images, str(tmp_path / "grid.png"), "Original", cols=5)
    with Image.open(tmp_path / "grid.png") as img:
        grid = np.asarray(img.convert("RGB"))
    scale = 8  # ceil(128 / 16)
    assert grid.shape == (32 + 2 * (16 * scale + 8), 5 * (12 * scale + 8) + 8, 3)
    first = grid[32:32 + 16 * scale:scale, 8:8 + 12 * scale:scale]
    np.testing.assert_array_equal(first, np.round(255 * images[0]).astype(np.uint8))
    last = grid[32 + 16 * scale + 8::scale][:16, 8 + 12 * scale + 8::scale][:, :12]
    np.testing.assert_array_equal(last[..., 0], np.round(255 * images[6][..., 0]))

    plots.histogram(str(tmp_path / "hist.png"),
                    {"Still Data": rng.randn(400), "Evaluation Data": rng.randn(200) + 2},
                    "Error Z-Score Histogram (Per Frame)", density=True, vline=3.0,
                    xlim=(-3.0, 70.0), log_y=True, xlabel="Z-Score", ylabel="Density")
    plots.histogram(str(tmp_path / "flat.png"), {"latent": np.zeros((4, 3))}, "Latent", bins=64)
    with Image.open(tmp_path / "hist.png") as img:
        hist = np.asarray(img.convert("RGB")).astype(int)
    assert hist.shape == (480, 640, 3)
    red = (hist[..., 0] > 180) & (hist[..., 1] < 90) & (hist[..., 2] < 90)
    bars = (hist[..., 2] > 150) & (hist[..., 0] < 140)  # the first series' blue
    assert red.sum() > 100 and bars.sum() > 100
    assert (tmp_path / "flat.png").stat().st_size > 0


def test_labelled_grid_layout(tmp_path, monkeypatch):
    """The tools' grids, with matplotlib unimportable: a blank cell stays white,
    each image sits in its cell scaled by a whole factor (to 64 pixels a side
    at least), a row with a label gets a band above its images."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.RandomState(8)
    a, b, c = (rng.rand(16, 12, 3) for _ in range(3))
    plots.labelled_grid([[(a, "X0"), None, (b, "X1")], [None, c, None]],
                        str(tmp_path / "grid.png"), title="J-Diagram")
    with Image.open(tmp_path / "grid.png") as img:
        page = np.asarray(img.convert("RGB"))
    scale, pad, band, head = 4, 4, 16, 30  # ceil(64 / 16); a one-line title's band
    cell_h, cell_w = 16 * scale, 12 * scale
    assert page.shape == (head + pad + band + 2 * (cell_h + pad), pad + 3 * (cell_w + pad), 3)
    y0 = head + pad + band
    np.testing.assert_array_equal(page[y0:y0 + cell_h:scale, pad:pad + cell_w:scale],
                                  np.round(255 * a).astype(np.uint8))
    x2 = pad + 2 * (cell_w + pad)
    np.testing.assert_array_equal(page[y0:y0 + cell_h:scale, x2:x2 + cell_w:scale],
                                  np.round(255 * b).astype(np.uint8))
    y1, x1 = y0 + cell_h + pad, pad + cell_w + pad
    np.testing.assert_array_equal(page[y1:y1 + cell_h:scale, x1:x1 + cell_w:scale],
                                  np.round(255 * c).astype(np.uint8))
    assert (page[y0:y0 + cell_h, x1:x1 + cell_w] == 255).all()  # the blank cell
    assert (page[head + pad:y0, pad:pad + cell_w] < 128).any()  # the label "X0"
    plots.labelled_grid([[rng.rand(70, 90, 1) for _ in range(2)]], str(tmp_path / "big.png"))
    with Image.open(tmp_path / "big.png") as img:
        assert img.size == (4 + 2 * (90 + 4), 4 + 70 + 4)  # no band, no title, scale 1


def test_histogram_panels_scatter_and_bars(tmp_path, monkeypatch):
    """Many overlaid series in one pass, panels composed on one page, the
    scatter's series and the bars drawn in their colours, without matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.RandomState(9)
    z = rng.randn(64, 300)
    many = plots.histogram_panel({str(i): z[:, i] for i in range(300)}, "columns",
                                 alpha=0.35, legend=False, density=True)
    one = plots.histogram_panel({"z": z[:, 0]}, "one column\nN= 64", density=True)
    bars = plots.bar_panel(np.array([1.5, 2.0, -0.5]), "kurtosis", hline=1.8,
                           hline_label="analytic 1.80")
    assert many.size == one.size == bars.size == (640, 480)
    plots.panels([many, one, bars], str(tmp_path / "panels.png"), "summary", cols=2)
    with Image.open(tmp_path / "panels.png") as img:
        assert img.size == (1280, 30 + 2 * 480)
    arr = np.asarray(many).astype(int)
    assert ((arr[..., 2] > 150) & (arr[..., 0] < 200) & (arr[..., 0] != arr[..., 2])).sum() > 100
    blue = np.asarray(bars).astype(int)
    assert ((blue[..., 0] == 31) & (blue[..., 1] == 119) & (blue[..., 2] == 180)).sum() > 1000
    plots.scatter(str(tmp_path / "scatter.png"), {"training": rng.randn(50, 2),
                                                  "validation": rng.randn(20, 2) + 3},
                  "PCA Embeddings\nLatent Dim: 8")
    with Image.open(tmp_path / "scatter.png") as img:
        pts = np.asarray(img.convert("RGB")).astype(int)
    for rgb in plots._SERIES_RGB[:2]:
        assert (np.abs(pts - np.array(rgb)).sum(axis=-1) == 0).sum() > 20, rgb
