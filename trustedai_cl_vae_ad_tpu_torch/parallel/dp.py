"""Data-parallel train, eval and forward steps.

Counterpart of ``trustedai_cl_vae_ad_tpu/parallel/dp.py``. There the train
step is one SPMD program over the global batch. Here each rank runs the
step on its rows with the losses' batch statistics taken over the data axis
(``batch_group``, ``collectives.py``); the parameter gradients are then
summed over the data axis in buckets, and the optimizer (replicated, or
ZeRO-1's) steps on every rank alike. The latent noise of a training step is
drawn for the GLOBAL batch from the model's generator, seeded alike on
every rank, and each rank keeps its rows: an R-rank step equals the 1-rank
step of the same global batch up to the order of the sums.
``training.loss_chunks`` has no data-parallel form, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import sum_gradients
from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, shard_batch

LOSS_CHUNKS_WARNING = (
    "WARNING: training.loss_chunks is not supported on the data-parallel path "
    "(chunk slicing would reshard the batch-sharded axis); using the full-batch loss. "
    "The per-chip batch is already 1/N of global: shrink the batch or run "
    "single-device if chunking is required.")


def global_rows_noise(generator: torch.Generator, local_shape, mesh: Mesh,
                      device) -> torch.Tensor:
    """N(0, 1) noise of this rank's rows: the global batch's draw from
    ``generator`` (rows = local rows x data axis), this rank's block kept."""
    rows = int(local_shape[0])
    full = torch.randn((rows * mesh.shape[DATA_AXIS],) + tuple(local_shape[1:]),
                       generator=generator, device=device, dtype=torch.float32)
    return full[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]


def loss_and_grads(core, params, x: torch.Tensor, mesh: Mesh,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None, weights=None):
    """(loss dict, x_hat, gradients) of this rank's rows ``x`` of the global
    batch; ``eps`` (this rank's rows) or the global draw's rows. The
    gradients are summed over the data axis."""
    if eps is None:
        eps = global_rows_noise(generator, (x.shape[0], core.latent_size), mesh, x.device)
    loss_dict, x_hat = core.compute_loss(x, training=True, return_inf=True, eps=eps,
                                         weights=weights, batch_group=mesh.data_group)
    grads = [g.contiguous() for g in torch.autograd.grad(loss_dict["loss"], params)]
    sum_gradients(grads, mesh.data_group)
    return loss_dict, x_hat, grads


def average_replicated(grads, mesh: Mesh, split: Sequence[bool]):
    """Average over the model axis, in place, the gradients of the parameters
    that ``split`` does not mark as tensor-parallel blocks. Every rank of a
    model group computes them from the same inputs, but not to the bit:
    cuDNN's default algorithms for the convolutions give other bits from run
    to run, on one rank too, while with ``torch.backends.cudnn.deterministic``
    the ranks agree to the bit (``chip_smoke.py`` phase (z3) holds both);
    unaveraged, the replicas would drift apart. No-op without a model axis."""
    n_model = mesh.shape[MODEL_AXIS]
    if n_model > 1:
        for g in sum_gradients([g for g, s in zip(grads, split) if not s], mesh.model_group):
            g.div_(n_model)
    return grads


def build_train_step(core, optimizer, mesh: Mesh, generator: torch.Generator,
                     split: Optional[Sequence[bool]] = None, loss_chunks: int = 0) -> Callable:
    """``step(x, eps=None, weights=None) -> (loss dict, x_hat)`` on this
    rank's rows; the optimizer (``ops.adam`` or ``zero.Zero1``) steps in
    place; ``split`` marks the optimizer's parameters that are
    tensor-parallel blocks."""
    if loss_chunks > 1:
        print(LOSS_CHUNKS_WARNING)
    split = list(split or [False] * len(optimizer.params))

    def step(x, eps=None, weights=None):
        loss_dict, x_hat, grads = loss_and_grads(core, optimizer.params, x, mesh, generator,
                                                 eps, weights)
        optimizer.step(average_replicated(grads, mesh, split))
        return {k: v.detach() for k, v in loss_dict.items()}, x_hat.detach()

    return step


def build_eval_step(core, mesh: Mesh) -> Callable:
    """``step(x) -> loss dict`` of the global batch (eval mode: no noise)
    from this rank's rows."""

    def step(x):
        with torch.no_grad():
            return core.compute_loss(x, training=False, batch_group=mesh.data_group)

    return step


def build_forward_step(fn: Callable, mesh: Mesh, replicas: Sequence) -> Callable:
    """Bulk scoring over a one-process mesh: ``step(x, *args)`` pads and
    splits the batch into one block of rows a device (``shard_batch``) and
    returns ``[fn(replica, rows, *args on its device)]`` in device order;
    ``replicas`` holds what each device's call needs. Every device's work is
    launched before any result is read."""

    def step(x, *args):
        return [fn(replica, rows, *(a.to(rows.device) for a in args))
                for replica, rows in zip(replicas, shard_batch(x, mesh))]

    return step
