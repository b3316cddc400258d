#!/usr/bin/env python3
"""Decoder explorer: a hand-set latent vector -> the decoded image (PyTorch port).

The counterpart of ``decoder_generator_qt.py`` on ``trustedai_cl_vae_ad_tpu_torch``:
loads a model log directory, shows one spinbox per latent dimension (5 columns)
and redraws the decoded image of the current z at most every 66 ms. Decodes run on
``--device`` (the card by default).

Headless modes (no PyQt5 needed):
  python decoder_generator_qt_torch.py <log_dir> --decode-z 0.1,0.5,... -o out.png
  python decoder_generator_qt_torch.py <log_dir> --histogram -o latents.png

``--histogram`` encodes the train and validation splits of the model's
``config.yml`` data section on the device and draws both latent histograms (64
bins each) with PIL (``viz/plots.py``); matplotlib is not used.
"""

import argparse
import sys

import numpy as np

try:
    from PyQt5.QtCore import QTimer
    from PyQt5.QtGui import QImage, QPixmap
    from PyQt5.QtWidgets import (
        QApplication,
        QDoubleSpinBox,
        QGridLayout,
        QHBoxLayout,
        QLabel,
        QMainWindow,
        QVBoxLayout,
        QWidget,
    )

    HAVE_QT = True
except ImportError:  # pragma: no cover
    HAVE_QT = False


def get_args(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("log_dir", type=str, help="Model log directory")
    parser.add_argument("--decode-z", type=str, default=None,
                        help="Comma-separated z vector -> headless decode to PNG")
    parser.add_argument("--histogram", action="store_true",
                        help="Headless: dump train/val latent histogram")
    parser.add_argument("--output", "-o", type=str, default="decoded.png")
    parser.add_argument("--warmup", action="store_true",
                        help="Decode one zero vector on the device before the window shows. "
                             "Nothing is compiled: what it warms is cuDNN's choice of "
                             "algorithms for the decoder's transposed convolutions and the "
                             "allocator, so the first spinbox change does not pay for them")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    args.device = checked_device(parser, args.device)
    return args


def _decode_to_host(model, z: np.ndarray) -> np.ndarray:
    """Decode (1, latent) z with sigmoid on the model's device; the (H, W, C) float
    image on the host."""
    return model.decode(z, apply_sigmoid=True)[0].float().cpu().numpy()


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8))


def decode_z_to_png(model, config, z_values, output_path):
    """Decode ``z_values`` (zero-padded or cut to the latent size) and save the PNG;
    returns the decoded image before rounding."""
    from PIL import Image

    latent = int(config["model"]["latent_dimensions"])
    z = np.zeros((1, latent), np.float32)
    z[0, : min(len(z_values), latent)] = z_values[:latent]
    img = _decode_to_host(model, z)
    u8 = _to_u8(img)
    if u8.shape[-1] == 3:
        Image.fromarray(u8, mode="RGB").save(output_path)
    else:
        # PIL's 'L' mode needs a 2-D array, not (H, W, 1)
        Image.fromarray(u8[..., 0], mode="L").save(output_path)
    print(f"decoded z -> {output_path}")
    return img


def latent_histograms_to_png(model, config, output_path):
    """Encode the train split (and the validation split, when the data section has
    one) on the model's device and draw the latents' histograms; returns
    {"train": z, ["val": z]} as float32 host arrays."""
    from trustedai_cl_vae_ad_tpu_torch.data.loader import iter_images, load_data
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import histogram

    data = load_data(config, device=model.device)

    def encode_split(split):
        zs = []
        for img in iter_images(split):
            # no float pre-cast: call_detailed takes uint8 frames as they are
            zs.append(model.call_detailed(img)[1].float().cpu().numpy())
        return np.concatenate(zs) if zs else np.zeros((0, 1), np.float32)

    series = {"train": encode_split(data["train"])}
    if data.get("val") is not None:
        series["val"] = encode_split(data["val"])
    histogram(output_path, series, "Latent Histograms", bins=64, alpha=0.65)
    print(f"latent histograms -> {output_path}")
    return series


if HAVE_QT:

    class DecoderGeneratorMainWindow(QMainWindow):
        REDRAW_MS = 66  # ~15 Hz debounce
        SPIN_COLS = 5

        def __init__(self, model, config):
            super().__init__()
            self.model = model
            self.config = config
            self.latent = int(config["model"]["latent_dimensions"])
            self._dirty = True

            self.image_label = QLabel("decoded")
            self.image_label.setMinimumSize(320, 240)

            grid = QGridLayout()
            self.spinboxes = []
            for i in range(self.latent):
                sb = QDoubleSpinBox()
                sb.setRange(-10.0, 10.0)
                sb.setSingleStep(0.1)
                sb.valueChanged.connect(self._mark_dirty)
                self.spinboxes.append(sb)
                grid.addWidget(QLabel(f"z{i}"), i // self.SPIN_COLS, 2 * (i % self.SPIN_COLS))
                grid.addWidget(sb, i // self.SPIN_COLS, 2 * (i % self.SPIN_COLS) + 1)

            layout = QHBoxLayout()
            layout.addWidget(self.image_label)
            right = QVBoxLayout()
            right.addLayout(grid)
            layout.addLayout(right)
            main = QWidget()
            main.setLayout(layout)
            self.setCentralWidget(main)

            self.timer = QTimer()
            self.timer.timeout.connect(self._redraw)
            self.timer.start(self.REDRAW_MS)

        def _mark_dirty(self, *_):
            self._dirty = True

        def _redraw(self):
            if not self._dirty:
                return
            self._dirty = False
            z = np.array([[sb.value() for sb in self.spinboxes]], np.float32)
            u8 = _to_u8(_decode_to_host(self.model, z))
            h, w, _ = u8.shape
            qimg = QImage(u8.data, w, h, 3 * w, QImage.Format_RGB888)
            self.image_label.setPixmap(
                QPixmap.fromImage(qimg).scaled(self.image_label.size())
            )


def main(argv=None):
    """Headless modes return what they drew (the decoded image, or the latents of
    each split); the window's event loop ends the process."""
    args = get_args(argv)

    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    model, config = load_model_from_directory(args.log_dir, device=args.device)

    if args.decode_z is not None:
        z_values = np.array([float(v) for v in args.decode_z.split(",")], np.float32)
        return decode_z_to_png(model, config, z_values, args.output)
    if args.histogram:
        return latent_histograms_to_png(model, config, args.output)

    if not HAVE_QT:
        print(
            "PyQt5 is not available. Headless modes:\n"
            "  --decode-z 0.1,0.2,...   decode a latent vector to PNG\n"
            "  --histogram              dump latent histograms",
            file=sys.stderr,
        )
        raise SystemExit(2)
    if args.warmup:
        latent = int(config["model"]["latent_dimensions"])
        print(f"warming up (one decode on {args.device}: cuDNN's algorithm choice and the "
              "allocator)")
        _decode_to_host(model, np.zeros((1, latent), np.float32))
    app = QApplication(sys.argv)
    window = DecoderGeneratorMainWindow(model, config)
    window.show()
    raise SystemExit(app.exec_())


if __name__ == "__main__":
    main()
