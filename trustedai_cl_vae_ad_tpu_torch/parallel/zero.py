"""ZeRO-1: the Adam moments sharded over the data axis.

Counterpart of ``trustedai_cl_vae_ad_tpu/parallel/zero.py`` (``training.zero1``).
A moment is sharded when it has at least ``min_elems`` (2**16) elements, the
axis that is flax's dim 0 divides by the data axis, and tensor parallelism
does not already split that axis: the JAX package's rule on the same tree.
flax's last axis is the port's dim 0 (``bridge.py``), so for a Dense weight
(out, in) the sharded axis is the port's dim 1 and composes with tp's split
of dim 0; biases shard along their one dim.

The step is the schedule the JAX docstring names. The gradients are summed
over the data axis whole (an all-reduce, so gloo works as NCCL does); each
rank updates its block of each sharded parameter with its block of the
gradient and its own block of mu and nu (the other parameters are updated
whole on every rank, as without ZeRO-1); then the updated blocks are
gathered into every rank's full parameter. The update is elementwise, so
the bits are those of the replicated update; ``adam_lean``'s stochastic
rounding of nu gives a block the bits that the whole tensor's draw gives it.
The moments are allocated in blocks from the start: the full replicated
state never exists on a rank. ``adam_fp8`` takes each block's ``Region``
(``block_regions``): its dither hash takes the element's index in the whole
tensor, and a block of whole flax rows owns its slice of the per-row scales,
so the bits are those of the replicated update too.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from trustedai_cl_vae_ad_tpu_torch.bridge import flax_leaf_layout
from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import QLeaf, Region, map_moment
from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import (
    all_gather_dim,
    gather_blocks_,
    rank_slice,
)
from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

MIN_ELEMS = 2 ** 16


def zero1_dims(params: Dict[str, torch.Tensor], mesh, min_elems: int = MIN_ELEMS,
               tp_dims: Optional[Dict[str, Optional[int]]] = None) -> Dict[str, Optional[int]]:
    """{parameter name: the port dim its moments are sharded along over the
    data axis, or None}. ``params`` hold the tensors as this rank has them
    (a tensor-parallel shard where ``tp_dims`` names a dim); the size test
    takes the whole tensor, as the JAX package's global arrays are."""
    n_data = mesh.shape[DATA_AXIS]
    tp_dims = tp_dims or {}
    _, axes = flax_leaf_layout(list(params), {k: p.dim() for k, p in params.items()})
    dims: Dict[str, Optional[int]] = {}
    for name, p in params.items():
        numel = p.numel() * (mesh.shape[MODEL_AXIS] if tp_dims.get(name) is not None else 1)
        dim = axes[name].index(0) if p.dim() else None
        dims[name] = dim if (dim is not None and numel >= min_elems
                             and p.shape[dim] % n_data == 0
                             and tp_dims.get(name) != dim) else None
    return dims


def block_regions(params: Dict[str, torch.Tensor], mesh,
                  tp_dims: Optional[Dict[str, Optional[int]]] = None,
                  zero_dims: Optional[Dict[str, Optional[int]]] = None) -> Dict[str, Region]:
    """{name: ``ops.adam8.Region``} of each parameter whose optimizer state
    is a block of a larger tensor on this rank: ``params`` as this rank holds
    them (a tensor-parallel block along ``tp_dims``, split over the model
    axis), their moments further split over the data axis along
    ``zero_dims`` (ZeRO-1)."""
    tp_dims, zero_dims = tp_dims or {}, zero_dims or {}
    regions = {}
    for name, p in params.items():
        shape, offsets, groups = list(p.shape), [0] * p.dim(), {}
        dim = tp_dims.get(name)
        if dim is not None:  # p is this rank's block of the whole tensor
            group = mesh.model_group
            offsets[dim] = dist.get_rank(group) * p.shape[dim]
            shape[dim] *= dist.get_world_size(group)
            groups[dim] = group
        dim = zero_dims.get(name)
        if dim is not None:  # its moments are this rank's block of p
            group = mesh.data_group
            offsets[dim] = dist.get_rank(group) * (p.shape[dim] // dist.get_world_size(group))
            groups[dim] = group
        if groups:
            regions[name] = Region(tuple(shape), tuple(offsets), groups)
    return regions


class Zero1:
    """``ops.adam.make_optimizer``'s optimizer with its moments sharded over
    the data axis of ``mesh``. Same surface: ``step(grads)`` (the gradients
    summed over the data axis, whole), ``learning_rate``, ``count``,
    ``name``, ``params``; ``state_dict`` / ``load_state_dict`` in the full
    layout (every rank takes part: the moments are gathered)."""

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate: float, mesh,
                 param_dtype: torch.dtype = torch.float32, name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None, stochastic_round_nu: bool = False,
                 min_elems: int = MIN_ELEMS, tp_dims: Optional[Dict[str, Optional[int]]] = None):
        from trustedai_cl_vae_ad_tpu_torch.ops.adam import make_optimizer, optimizer_name

        self.mesh = mesh
        self.group = mesh.data_group
        self.name = optimizer_name(name, param_dtype)
        self.names = list(params)
        self.params = [params[k] for k in self.names]
        self.dims = zero1_dims(params, mesh, min_elems, tp_dims)
        views = {k: p if self.dims[k] is None else rank_slice(p, self.dims[k], self.group)
                 for k, p in params.items()}
        fp8 = self.name == "adam_fp8"
        self.inner = make_optimizer(
            views, learning_rate, param_dtype=param_dtype, name=self.name,
            stochastic_round_nu=stochastic_round_nu, generator=generator,
            regions=block_regions(params, mesh, tp_dims, self.dims) if fp8 else None)
        for i, k in enumerate(self.names):
            dim = self.dims[k]
            if dim is not None and not fp8:
                block = views[k].shape[dim]
                self.inner.regions[i] = (tuple(params[k].shape), dim,
                                         block * self.mesh.data_rank)

    @property
    def learning_rate(self) -> float:
        return self.inner.learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float) -> None:
        self.inner.learning_rate = float(value)

    @property
    def count(self) -> int:
        return self.inner.count

    def sharded(self):
        """(name, dim) of the parameters whose moments are sharded."""
        return [(k, d) for k, d in self.dims.items() if d is not None]

    def step(self, grads) -> None:
        """One update from the gradients summed over the data axis (every
        rank holds them whole), then the updated blocks gathered."""
        grads = [g if self.dims[k] is None else rank_slice(g, self.dims[k], self.group)
                 for k, g in zip(self.names, grads)]
        self.inner.step(grads)
        with torch.no_grad():
            for k, p in zip(self.names, self.params):
                if self.dims[k] is not None:
                    gather_blocks_(p, self.dims[k], self.group)

    def moment_bytes(self) -> int:
        """Bytes of this rank's mu and nu (a quantized leaf's three tensors)."""
        return sum(t.numel() * t.element_size() for m in self.inner.mu + self.inner.nu
                   for t in (m if isinstance(m, QLeaf) else (m,)))

    def full_moment(self, kind: str, name: str):
        """One moment in the full layout (a collective for a sharded one): a
        tensor, or a quantized leaf's {'q', 'scale', 'scale_next'}."""
        return map_moment(self.inner.full_moment(kind, name), name, self.dims[name],
                          lambda t, dim: t if dim is None else all_gather_dim(t, dim, self.group))

    def state_dict(self) -> dict:
        """The full layout: {'count', 'learning_rate', 'mu', 'nu'}; every
        sharded moment is gathered (a collective: every rank calls it)."""
        return {"count": int(self.count), "learning_rate": float(self.learning_rate),
                "mu": {k: self.full_moment("mu", k) for k in self.names},
                "nu": {k: self.full_moment("nu", k) for k in self.names}}

    def load_state_dict(self, state: dict) -> None:
        """Restore from the full layout: each rank keeps its blocks."""
        blocks = {"count": state["count"], "learning_rate": state.get("learning_rate")}
        for kind in ("mu", "nu"):
            blocks[kind] = {k: map_moment(t, k, self.dims[k], lambda v, dim: v if dim is None
                                          else rank_slice(v, dim, self.group))
                            for k, t in state[kind].items()}
        self.inner.load_state_dict(blocks)
