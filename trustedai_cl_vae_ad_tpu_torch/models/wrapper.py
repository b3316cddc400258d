"""Stateful model wrapper: inference, the training step, save and load.

Counterpart of ``trustedai_cl_vae_ad_tpu/models/wrapper.py::VAEModel``: the
mutable model API (``encode / reparameterize / decode / sample / call /
call_detailed / compute_loss / train_step / test_step / train_step_and_run``),
with ``beta`` (the input-noise stddev) and the
optimizer's learning rate mutable at run time. PyTorch runs eagerly, so
neither needs a rebuild of anything. Parameters and Adam moments are updated
in place.

On a mesh of ranks (``parallel/``: one process, one device each) the model
trains data-parallel over the global batch, with ZeRO-1 moments
(``training.zero1``) and tensor-parallel Dense layers on a model axis; the
training methods take the global batch and keep this rank's rows, and
``save_model`` gathers the state to global rank 0, which writes it.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.models.cvae import AbstractCVAE
from trustedai_cl_vae_ad_tpu_torch.ops.adam import Adam, make_optimizer, optimizer_name
from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import AdamFp8, map_moment
from trustedai_cl_vae_ad_tpu_torch.parallel import tp, zero
from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch


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
        self.optimizer: Optional[Union[Adam, AdamFp8, zero.Zero1]] = None
        self.mesh: Optional[Mesh] = None
        #: {state-dict key: the dim split over the model axis, or None}
        self.tp_dims: dict = {}
        self._train_step = self._eval_step = None

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

    def compile(self, learning_rate: Optional[float] = None, mesh: Optional[Mesh] = None,
                zero1: Optional[bool] = None) -> None:
        """Attach the optimizer named by ``training.optimizer`` (``adam``,
        ``adam_lean`` or ``adam_fp8``; default: ``adam`` for float32
        parameters, ``adam_lean`` for bfloat16).

        With ``mesh`` (a mesh of ranks, ``parallel.mesh.make_mesh``) the
        parameters are broadcast from global rank 0, the big Dense layers
        split over the model axis, and the train step runs data-parallel.
        ``zero1`` (default: ``training.zero1``) shards the Adam moments over
        the data axis, freeing (N-1)/N of the optimizer memory per rank."""
        training = self.config.get("training", {})
        if learning_rate is None:
            learning_rate = float(training["learning_rate"])
        if mesh is not None:
            self._join_mesh(mesh)
        self.optimizer = self._make_optimizer(learning_rate, zero1)
        self._build_steps()

    def _make_optimizer(self, learning_rate: float, zero1: Optional[bool]):
        training = self.config.get("training", {})
        if zero1 is None:
            zero1 = bool(training.get("zero1", False))
        named = dict(self.core.named_parameters())
        kwargs = dict(param_dtype=next(iter(named.values())).dtype,
                      name=training.get("optimizer"), generator=self.generator)
        if self.mesh is not None and zero1:
            return zero.Zero1(named, learning_rate, self.mesh, tp_dims=self.tp_dims, **kwargs)
        regions = None
        if self.mesh is not None and optimizer_name(kwargs["name"],
                                                    kwargs["param_dtype"]) == "adam_fp8":
            # a block of a Dense weight split over the model axis: its moments are the
            # block's, the scales' absmax taken over the model group
            regions = zero.block_regions(named, self.mesh, self.tp_dims)
        return make_optimizer(named, learning_rate, regions=regions, **kwargs)

    def _join_mesh(self, mesh: Mesh) -> None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not {type(mesh)}")
        if not mesh.distributed:
            raise ValueError("training runs one process per device: initialize_distributed, "
                             "then make_mesh over the ranks")
        if mesh.device != self.device:
            raise ValueError(f"the mesh's device {mesh.device} is not the model's {self.device}")
        if self.mesh is not None:
            raise RuntimeError(f"the model is already on {self.mesh}")
        # every rank starts from rank 0's weights
        replicate(dict(self.core.named_parameters()), mesh)
        self.mesh = mesh
        self.tp_dims = tp.shard_model(self.core, mesh)

    def _build_steps(self) -> None:
        if self.mesh is None:
            self._train_step = self._eval_step = None
            return
        from trustedai_cl_vae_ad_tpu_torch.parallel import dp

        loss_chunks = int((self.config.get("training") or {}).get("loss_chunks", 0) or 0)
        split = [self.tp_dims.get(k) is not None for k in self.optimizer.names]
        self._train_step = dp.build_train_step(self.core, self.optimizer, self.mesh,
                                               self.generator, split, loss_chunks=loss_chunks)
        self._eval_step = dp.build_eval_step(self.core, self.mesh)

    def place_on_mesh(self, mesh: Mesh) -> None:
        """Move a compiled (e.g. restored) model onto a mesh of ranks keeping
        its state: the parameters and the Adam moments, their step count and
        learning rate (a fresh ``compile(mesh=...)`` would start Adam anew).
        Honors ``training.zero1``: restored moments land in their shards. The
        optimizer is rebuilt only where the moments' layout changes (ZeRO-1,
        or a Dense layer split over the model axis)."""
        state = self.optimizer.state_dict() if self.optimizer is not None else None
        self._join_mesh(mesh)
        if state is None:
            return
        zero1 = bool(self.config.get("training", {}).get("zero1", False))
        if zero1 or any(d is not None for d in self.tp_dims.values()):
            for kind in ("mu", "nu"):
                state[kind] = {k: map_moment(t, k, self.tp_dims.get(k),
                                             lambda v, dim: tp.shard_tensor(v, dim, mesh))
                               for k, t in state[kind].items()}
            self.optimizer = self._make_optimizer(state["learning_rate"], zero1)
            self.optimizer.load_state_dict(state)
        del state
        self._build_steps()

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
        x = self._as_image_input(x)
        with torch.no_grad():
            return self.core.encode(x, training=training, generator=self.generator)

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

    def _local_rows(self, *tensors):
        """This rank's rows of each global-batch tensor, padded as
        ``parallel.mesh.shard_batch`` pads (None passes through)."""
        return tuple(None if t is None else shard_batch(torch.as_tensor(t).to(self.device),
                                                        self.mesh)[0] for t in tensors)

    def test_step(self, x):
        """The eval-mode loss dict; on a mesh that of the global batch x, from
        this rank's rows of it."""
        if self.mesh is not None:
            (x,) = self._local_rows(self._as_image_input(x))
            return self._eval_step(x)
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
        engine's padded replay buffer). On a mesh, x, eps and weights are
        the global batch, padded as ``parallel.mesh.shard_batch`` pads, of
        which this rank keeps its rows; the statistics are the global
        batch's, and x_hat is this rank's rows."""
        optimizer = self._need_optimizer()
        x = self._as_image_input(x)
        if self.mesh is not None:
            x, eps, weights = self._local_rows(x, eps, weights)
            return self._train_step(x, eps=eps, weights=weights)
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
        background; the round commits at the saver's next ``wait``. On a
        mesh every rank must call it: the state is gathered whole to global
        rank 0 one tensor at a time and written there, synchronously (no
        saver), in the files a single device writes."""
        from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import save_checkpoint

        if self.mesh is not None:
            params, opt_state = self._gathered_state(include_optimizer)
            save_checkpoint(log_dir, params, opt_state=opt_state, mesh=self.mesh)
            return
        opt_state = None
        if include_optimizer and self.optimizer is not None:
            opt_state = self.optimizer.state_dict()
        if saver is not None:
            saver.save(log_dir, self.params, opt_state=opt_state)
        else:
            save_checkpoint(log_dir, self.params, opt_state=opt_state)

    def _gathered_state(self, include_optimizer: bool):
        """(params, optimizer state) whole, on the host of global rank 0 ({}
        and None elsewhere), gathered one tensor at a time: a ZeRO-1 moment
        over the data axis, a tensor-parallel block over the model axis."""
        keep = self.mesh.is_primary

        def host(t, dim):
            t = tp.full_tensor(t, dim, self.mesh)
            return t.detach().to("cpu") if keep else None

        params = {k: host(t, self.tp_dims.get(k)) for k, t in self.core.state_dict().items()}
        opt_state = None
        if include_optimizer and self.optimizer is not None:
            opt_state = {"count": self.optimizer.count,
                         "learning_rate": self.optimizer.learning_rate}
            for kind in ("mu", "nu"):
                opt_state[kind] = {k: map_moment(self.optimizer.full_moment(kind, k), k,
                                                 self.tp_dims.get(k), host)
                                   for k in self.optimizer.names}
        if not keep:
            return {}, None
        return params, opt_state

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
