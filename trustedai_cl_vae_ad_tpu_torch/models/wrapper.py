"""Minimal stateful model wrapper for inference.

Counterpart of the inference part of ``trustedai_cl_vae_ad_tpu/models/
wrapper.py::VAEModel``. The optimizer, the train steps and save/load are
ROADMAP queue 1 items 7 and 8.
"""

from __future__ import annotations

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.models.cvae import AbstractCVAE


class VAEModel:
    """A CVAE core on one device."""

    def __init__(self, core: AbstractCVAE, device):
        self.core = core.eval()
        self.device = torch.device(device)

    @property
    def params(self) -> dict:
        """The core's state (tensors shared with the module)."""
        return self.core.state_dict()

    def _as_image_input(self, x) -> torch.Tensor:
        """uint8 passes through raw (the core normalizes on the device);
        anything else widens to float32."""
        x = torch.as_tensor(x)
        if x.dtype != torch.uint8:
            x = x.to(torch.float32)
        return x.to(self.device)

    def call(self, x, training: bool = False) -> torch.Tensor:
        with torch.inference_mode():
            return self.core.call(self._as_image_input(x), training=training)

    def predict(self, x) -> np.ndarray:
        return self.call(x).cpu().numpy()
