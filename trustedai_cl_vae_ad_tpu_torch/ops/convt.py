"""TF-SAME transposed convolution, forward only.

Counterpart of ``trustedai_cl_vae_ad_tpu/ops/convt.py::conv_transpose_same``
(which is ``lax.conv_transpose(..., "SAME", transpose_kernel=True)``, i.e.
Keras Conv2DTranspose). The JAX module's custom VJP exists to keep XLA from
reversing whole activations in the backward pass; torch's conv_transpose2d
backward has no such op, so autograd's own gradient is used.

This op works in torch's NCHW layout with ConvTranspose2d's weight layout
(in, out, kh, kw): it sits inside the decoder, which converts at its edges.
A flax ConvTranspose kernel P (kh, kw, out, in) maps to it as
``P.permute(3, 2, 0, 1)``, with no spatial flip (``bridge.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """TF 'SAME' padding of a strided conv over an axis of length n:
    out = ceil(n / stride), total = max((out - 1) * stride + k - n, 0),
    split as (total // 2, the rest)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_transpose_same(x: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """NCHW transposed conv with TF 'SAME' output size (in * stride), no bias.

    The full transposed conv is (in - 1) * stride + k long; TF keeps the
    window that starts (k - stride) // 2 in. For stride 2 and k = 3 that is
    the FIRST 2n rows and columns — torch's ``padding=1, output_padding=1``
    keeps the last ones instead. For stride 1 it equals ``padding=1``.
    """
    k = weight.shape[2]
    lo = max(k - stride, 0) // 2
    y = F.conv_transpose2d(x, weight, None, stride=stride, padding=lo)
    h, w = x.shape[2] * stride, x.shape[3] * stride
    if y.shape[2] != h or y.shape[3] != w:
        y = y[:, :, :h, :w]
    return y
