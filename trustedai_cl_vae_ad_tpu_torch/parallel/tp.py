"""Tensor parallelism: the big Dense weights split over the model axis.

Counterpart of ``trustedai_cl_vae_ad_tpu/parallel/tp.py``. The flagship's
parameters sit almost all in two Dense layers (the encoder's 268800 -> 4000
and the decoder's 2000 -> 134400); a Dense weight with at least
``min_params`` elements whose output features divide by the model axis is
column-sharded: each rank of a model group holds its block of the output
features (the port's dim 0) and the whole bias. Everything else is
replicated.

Forward: the input is copied into the model group (its gradient is summed
there), each rank multiplies by its block, the (small) outputs are gathered
along the features, then the bias is added. Composes with dp and ZeRO-1 on
one (data, model) mesh, as ``build_train_step_sharded`` does in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import (
    all_gather_dim,
    copy_into_group,
    gather_features,
    rank_slice,
)
from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import MODEL_AXIS

SHARD_MIN_PARAMS = 1 << 20


def param_shardings(params: Dict[str, torch.Tensor], mesh,
                    min_params: int = SHARD_MIN_PARAMS) -> Dict[str, Optional[int]]:
    """{state-dict key: 0 for a Dense weight split along its output features
    over the model axis, else None}: a 2-D leaf of a layer named Dense with
    at least ``min_params`` elements and output features that divide by the
    model axis (the JAX package's rule; ``min_params`` is lowered by tests)."""
    n_model = mesh.shape[MODEL_AXIS]
    return {name: 0 if (n_model > 1 and p.dim() == 2 and p.numel() >= min_params
                        and "Dense" in name and p.shape[0] % n_model == 0) else None
            for name, p in params.items()}


class ShardedDense(nn.Module):
    """A Dense layer holding this rank's block of output features of its
    weight (``weight``, (out / n_model, in)) and its whole ``bias``."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        self.group = group

    def apply_sharded(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.linear(copy_into_group(x, self.group), self.weight.to(dtype))
        return gather_features(y, self.group) + self.bias.to(dtype)


def shard_model(core: nn.Module, mesh, min_params: int = SHARD_MIN_PARAMS
                ) -> Dict[str, Optional[int]]:
    """Replace each Dense layer that ``param_shardings`` picks by a
    ``ShardedDense`` holding this rank's block (the state-dict keys stay);
    returns the shardings."""
    shardings = param_shardings(dict(core.named_parameters()), mesh, min_params)
    for name, dim in shardings.items():
        if dim is None:
            continue
        layer_path = name.rsplit(".", 1)[0]
        parent_path, layer_name = layer_path.rsplit(".", 1)
        layer = core.get_submodule(layer_path)
        with torch.no_grad():
            block = rank_slice(layer.weight, 0, mesh.model_group).clone()
            bias = layer.bias.detach().clone()
        core.get_submodule(parent_path)[layer_name] = ShardedDense(block, bias, mesh.model_group)
    return shardings


def full_tensor(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """A model-sharded tensor gathered whole (a collective of the model
    group); a replicated one as it is."""
    return t if dim is None else all_gather_dim(t.detach(), dim, mesh.model_group)


def shard_tensor(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """This rank's block of a whole tensor."""
    return t if dim is None else rank_slice(t, dim, mesh.model_group)
