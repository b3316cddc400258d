"""Device-side resize of frames to model size.

Counterpart of the resize in ``trustedai_cl_vae_ad_tpu/data/ingest.py`` and
``stream/engine.py`` (``jax.image.resize(method="linear", antialias=True)``,
the tf.image.resize(antialias=True) algorithm). ``F.interpolate`` with
``mode="bilinear", antialias=True, align_corners=False`` computes the same
triangle-kernel resize (tests/test_torch_resize.py pins it). The device
cache and the prefetch pipeline are ROADMAP queue 1 item 10.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_images(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of an NHWC float batch to ``out_hw``."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      antialias=True, align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()
