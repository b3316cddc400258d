"""Peaks of the card, kernel 1's bytes, and the CVAE's operations from its shapes.

``HBM_BYTES_PER_S``, ``PEAK`` and ``stream_score`` are frozen copies of
``kernel_bounds_torch.py`` at commit d792d55 (NVIDIA's H100 SXM data sheet:
3.35 TB/s, 989 TFLOP/s bf16 dense, 1,979 TOP/s int8 dense, 67 TFLOP/s float32
outside the tensor cores), unchanged but for this header.

``forward_macs`` counts the multiply-adds of one frame's forward pass from the
configuration alone: the strided convolutions by output pixel, the transposed
convolutions by input pixel (every input pixel meets every 3x3 tap once), the
dense layers by weight. A training step counts three forwards (the forward, and
the backward's two products a layer).
"""

from __future__ import annotations

from typing import Dict

# -- frozen copy of kernel_bounds_torch.py (d792d55) -------------------------------------
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def stream_score(k, h, w, c):
    """ops/stream_score.py: img, rec read; maps, scalars read and written; norm and [score,
    count] written; about 3 operations a channel and 30 a pixel (as chip_smoke.py counts)."""
    return 4 * k * (2 * h * w * c + 2 * 2 * h * w + 2 * 6 + h * w + 2), k * h * w * (3 * c + 30)
# -- end of the frozen copy --------------------------------------------------------------

#: the peak a step's operations run against, by the configuration's training.precision
#: (float32 runs with TF32 off, outside the tensor cores)
PRECISION_PEAK = {"float32": PEAK["f32"], "bfloat16": PEAK["bf16"]}


def _halve(n: int, times: int) -> int:
    for _ in range(times):
        n = -(-n // 2)
    return n


def forward_macs(config: dict) -> Dict[str, int]:
    """Multiply-adds of one frame's forward pass, by kind of layer."""
    h, w, c = (int(v) for v in config["data"]["image_size"])
    model = config["model"]
    filters = [int(f) for f in model["layers"]]
    latent = int(model["latent_dimensions"])
    ddf = int(model["decoder_dense_filters"])
    edf = model.get("encoder_dense_filters")
    conv, cin = 0, c
    for i, f in enumerate(filters):
        conv += _halve(h, i + 1) * _halve(w, i + 1) * f * 9 * cin
        cin = f
    flat = _halve(h, len(filters)) * _halve(w, len(filters)) * cin
    enc = flat * int(edf) + int(edf) * 2 * latent if edf else flat * 2 * latent
    dh, dw = int(h / 2 ** len(filters)), int(w / 2 ** len(filters))
    dec = latent * dh * dw * ddf
    convt, cin, ph, pw = 0, ddf, dh, dw
    for f in list(reversed(filters)):
        convt += ph * pw * cin * f * 9
        cin, ph, pw = f, ph * 2, pw * 2
    convt += ph * pw * cin * c * 9
    return {"conv": conv, "encoder_dense": enc, "decoder_dense": dec, "conv_transpose": convt,
            "total": conv + enc + dec + convt}


def forward_flops(config: dict) -> int:
    """Operations of one frame's forward pass: two a multiply-add."""
    return 2 * forward_macs(config)["total"]


def peak_flops(config: dict) -> float:
    precision = str(config.get("training", {}).get("precision", "float32")).lower()
    return PRECISION_PEAK[precision]
