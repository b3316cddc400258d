"""Stateful model wrapper: inference, the training step, save and load.

Counterpart of ``trustedai_cl_vae_ad_tpu/models/wrapper.py::VAEModel``: the
mutable model API (``encode / reparameterize / decode / sample / call /
call_detailed / compute_loss / train_step / test_step / train_step_and_run``),
with ``beta`` (the input-noise stddev) and the
optimizer's learning rate mutable at run time. PyTorch runs eagerly, so
neither needs a rebuild of anything. Parameters and Adam moments are updated
in place. Device meshes and ZeRO-1 are not ported (ROADMAP queue 1 item 17).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.models.cvae import AbstractCVAE
from trustedai_cl_vae_ad_tpu_torch.ops.adam import Adam, make_optimizer
from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import AdamFp8


class VAEModel:
    """A CVAE core on one device, with an optional optimizer."""

    def __init__(self, core: AbstractCVAE, device, seed: int = 0):
        # eval mode throughout: the core has no dropout or batch norm, so the
        # mode changes nothing; "training" is an argument of its methods
        self.core = core.eval()
        self.config = core.config
        self.latent_size = core.latent_size
        self.encoder_input_shape = core.encoder_input_shape
        self.device = torch.device(device)
        #: draws the latent eps of training steps and encode's input noise
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.optimizer: Optional[Union[Adam, AdamFp8]] = None

    @property
    def params(self) -> dict:
        """The core's state (tensors shared with the module)."""
        return self.core.state_dict()

    # -- mutable hyperparameters --------------------------------------------------
    @property
    def beta(self) -> float:
        return float(self.core.beta)

    @beta.setter
    def beta(self, value: float) -> None:
        self.core.beta = float(value)

    def _need_optimizer(self) -> Union[Adam, AdamFp8]:
        if self.optimizer is None:
            raise RuntimeError("model not compiled: call model.compile() first")
        return self.optimizer

    @property
    def learning_rate(self) -> float:
        return self._need_optimizer().learning_rate

    def set_learning_rate(self, lr: float) -> None:
        """Re-dial Adam's learning rate; takes effect at the next step."""
        self._need_optimizer().learning_rate = float(lr)

    def compile(self, learning_rate: Optional[float] = None, mesh=None, zero1=None) -> None:
        """Attach the optimizer named by ``training.optimizer`` (``adam``,
        ``adam_lean`` or ``adam_fp8``; default: ``adam`` for float32
        parameters, ``adam_lean`` for bfloat16)."""
        if mesh is not None or zero1:
            raise NotImplementedError(
                "device meshes and ZeRO-1 are not ported yet (ROADMAP.md queue 1 item 17)")
        training = self.config.get("training", {})
        if learning_rate is None:
            learning_rate = float(training["learning_rate"])
        named = dict(self.core.named_parameters())
        self.optimizer = make_optimizer(
            named, learning_rate, param_dtype=next(iter(named.values())).dtype,
            name=training.get("optimizer"), generator=self.generator)

    # -- inference ----------------------------------------------------------------
    def _as_image_input(self, x) -> torch.Tensor:
        """uint8 passes through raw (the core normalizes on the device);
        anything else widens to float32."""
        x = torch.as_tensor(x)
        if x.dtype != torch.uint8:
            x = x.to(torch.float32)
        return x.to(self.device)

    def encode(self, x, training: bool = False):
        """(mean, logvar); with ``training`` the input is fuzzed with
        N(0, beta) noise drawn from the model's generator."""
        with torch.no_grad():
            return self.core.encode(self._as_image_input(x), training=training,
                                    generator=self.generator)

    def _as_latent(self, z) -> torch.Tensor:
        return torch.as_tensor(z).to(self.device, torch.float32)

    def reparameterize(self, mean, logvar, training: bool = False,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z = mean + 0.5*logvar + eps: eps is zero in eval mode; in training
        mode it is ``eps`` when given, else drawn from the model's generator."""
        with torch.no_grad():
            return self.core.reparameterize(
                self._as_latent(mean), self._as_latent(logvar), training=training,
                eps=None if eps is None else self._as_latent(eps), generator=self.generator)

    def decode(self, z, apply_sigmoid: bool = False) -> torch.Tensor:
        with torch.inference_mode():
            return self.core.decode(self._as_latent(z), apply_sigmoid=apply_sigmoid)

    def sample(self, eps=None, n: int = 100) -> torch.Tensor:
        """Decode ``eps`` (or n latents drawn from the model's generator) with sigmoid."""
        with torch.inference_mode():
            return self.core.sample(None if eps is None else self._as_latent(eps), n=n,
                                    generator=self.generator)

    def call(self, x, training: bool = False,
             eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.inference_mode():
            return self.core.call(self._as_image_input(x), training=training,
                                  eps=None if eps is None else self._as_latent(eps),
                                  generator=self.generator)

    def __call__(self, x, training: bool = False, eps: Optional[torch.Tensor] = None):
        return self.call(x, training, eps=eps)

    def call_detailed(self, x, training: bool = False, eps: Optional[torch.Tensor] = None):
        """(x_prob, z, mean, logvar), as the JAX model returns them; ``training``
        gates only the latent eps (the encoder input is not fuzzed)."""
        with torch.inference_mode():
            return self.core.call_detailed(self._as_image_input(x), training=training,
                                           eps=None if eps is None else self._as_latent(eps),
                                           generator=self.generator)

    def predict(self, x) -> np.ndarray:
        return self.call(x).cpu().numpy()

    def compute_loss(self, x, training: bool = False, return_inf: bool = False,
                     eps: Optional[torch.Tensor] = None):
        """The loss dict (device tensors), without gradients."""
        with torch.no_grad():
            return self.core.compute_loss(self._as_image_input(x), training=training,
                                          return_inf=return_inf, eps=eps,
                                          generator=self.generator)

    def test_step(self, x):
        return self.compute_loss(x, training=False)

    # -- training -----------------------------------------------------------------
    def train_step(self, x, eps: Optional[torch.Tensor] = None) -> dict:
        """One gradient step; returns the loss dict."""
        loss, _ = self.train_step_and_run(x, eps=eps)
        return loss

    def train_step_and_run(self, x, eps: Optional[torch.Tensor] = None, weights=None):
        """One gradient step; returns (loss dict, x_hat) as detached device
        tensors, without waiting for the device. ``eps`` injects the latent
        noise (B, latent); otherwise it is drawn from the model's generator.
        ``weights`` (B,) masks rows out of every batch statistic (the live
        engine's padded replay buffer)."""
        optimizer = self._need_optimizer()
        x = self._as_image_input(x)
        loss_dict, x_hat = self.core.compute_loss(x, training=True, return_inf=True, eps=eps,
                                                  generator=self.generator, weights=weights)
        grads = torch.autograd.grad(loss_dict["loss"], optimizer.params)
        optimizer.step(list(grads))
        return {k: v.detach() for k, v in loss_dict.items()}, x_hat.detach()

    # -- checkpointing (logdir ABI: encoder/ decoder/ optimizer/) -------------------
    def save_model(self, log_dir: str, include_optimizer: bool = True, saver=None) -> None:
        """Write one checkpoint round. With ``saver`` (a
        ``train.checkpoint.AsyncSaver``) the call returns once the state is
        copied off the live tensors, and the files are written in the
        background; the round commits at the saver's next ``wait``."""
        from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import save_checkpoint

        opt_state = None
        if include_optimizer and self.optimizer is not None:
            opt_state = self.optimizer.state_dict()
        if saver is not None:
            saver.save(log_dir, self.params, opt_state=opt_state)
        else:
            save_checkpoint(log_dir, self.params, opt_state=opt_state)

    def load_model(self, model_path: str, restore_optimizer: Optional[bool] = None) -> None:
        """Restore the weights, and the optimizer state if present (the Adam
        moments, their step count and the learning rate), in place, from a
        log directory of this package or of the JAX package.

        ``restore_optimizer``:
          * None (default): restore the moments only if the model is already
            compiled, so inference-only tools never allocate Adam state;
          * True: compile if needed and restore the moments (resume);
          * False: parameters only.
        """
        from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import (
            has_optimizer,
            restore_optimizer_state,
            restore_params,
        )

        has_opt = has_optimizer(model_path)
        if restore_optimizer is True and self.optimizer is None and has_opt:
            self.compile()
        self.core.load_state_dict(restore_params(model_path, map_location=self.device))
        if restore_optimizer is not False and self.optimizer is not None and has_opt:
            self.optimizer.load_state_dict(
                restore_optimizer_state(model_path, map_location=self.device))
