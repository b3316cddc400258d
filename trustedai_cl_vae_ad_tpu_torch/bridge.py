"""Weight bridge between a flax parameter tree and the port's state dict;
gradients and Adam moments cross the same way.

The tree is the JAX core's ``{'encoder': {...}, 'decoder': {...}}`` with
numpy leaves (``jax.device_get(params)``); this module takes numpy only, so
it runs without jax. The port's submodules carry the flax layer names, so
the state-dict key of ``encoder/Conv_0/kernel`` is
``encoder.layers.Conv_0.weight`` and every flax name stays recoverable.

Layouts:
  * Conv: flax HWIO (kh, kw, in, out) -> torch OIHW (out, in, kh, kw);
  * Dense: flax (in, out) -> torch (out, in);
  * ConvTranspose: flax (kh, kw, out, in) with ``transpose_kernel=True`` ->
    ConvTranspose2d (in, out, kh, kw) = ``permute(3, 2, 0, 1)``, with no
    spatial flip (pinned by tests/test_torch_bridge.py);
  * biases are unchanged.
bfloat16 leaves (ml_dtypes) cross as their uint16 bits, never through float
arithmetic, and stay bfloat16; ``load_state_dict`` casts every leaf to the
model's parameter dtype.

``adam_fp8``'s moments (``ops/adam8.py``) are lists, one entry a leaf of the
parameters in ``jax.tree_util.tree_flatten`` order: dict keys sorted at each
level, so ``decoder`` before ``encoder`` and ``ConvTranspose_*`` before
``Conv_*`` before ``Dense_*`` (``flax_leaf_layout``). An entry is an array or a
quantized leaf ``{q, scale, scale_next}``; each of its arrays crosses by its
parameter's permutation (a scale's size-1 axis is flax's last, the port's dim
0).

The int8 serving tree (``ops/quant.py``) crosses as a tree: a quantized Dense
``{kernel_i8 (in, out), scale, bias}`` of the JAX package becomes
``{kernel_i8 (out, in), scale, bias}``, every other layer ``{weight, bias}``
in the layouts above. The encoder's first Dense needs no reordering of its
268800 inputs: both packages flatten the last feature map in HWC order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# flax layer-name prefix -> permutation from flax kernel to torch weight
_TO_TORCH = {
    "ConvTranspose_": (3, 2, 0, 1),
    "Conv_": (3, 2, 0, 1),
    "Dense_": (1, 0),
}


def _perm(layer: str):
    for prefix, perm in _TO_TORCH.items():
        if layer.startswith(prefix):
            return perm
    raise KeyError(f"unknown flax layer name {layer!r}")


def _inverse(perm):
    return tuple(int(i) for i in np.argsort(perm))


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``a`` in its own dtype; bfloat16 (ml_dtypes) crosses as
    its uint16 bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """flax tree of numpy arrays -> state dict of CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for part in ("encoder", "decoder"):
        for layer, leaves in tree[part].items():
            for leaf, arr in leaves.items():
                a = np.asarray(arr)
                if leaf == "kernel":
                    a = a.transpose(_perm(layer))
                    name = "weight"
                elif leaf == "bias":
                    name = "bias"
                else:
                    raise KeyError(f"unknown flax leaf {part}/{layer}/{leaf}")
                out[f"{part}.layers.{layer}.{name}"] = _tensor(a)
    return out


def params_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """State dict -> flax tree of numpy arrays (float32 for bf16 weights)."""
    tree: dict = {"encoder": {}, "decoder": {}}
    for key, t in state_dict.items():
        part, _layers, layer, name = key.split(".")
        a = t.detach().to("cpu")
        if a.dtype == torch.bfloat16:
            a = a.to(torch.float32)
        a = a.numpy()
        if name == "weight":
            tree[part].setdefault(layer, {})["kernel"] = np.ascontiguousarray(
                a.transpose(_inverse(_perm(layer))))
        else:
            tree[part].setdefault(layer, {})["bias"] = a.copy()
    return tree


def opt_state_from_optax(count, mu_tree: dict, nu_tree: dict, learning_rate=None) -> dict:
    """optax's Adam state (``count``, ``mu``, ``nu``; the moment trees have
    the parameters' structure and cross by the same permutations; the
    learning rate that ``inject_hyperparams`` keeps, when given) -> the dict
    that ``ops.adam.Adam.load_state_dict`` takes."""
    state = {"count": int(count), "mu": params_from_flax(mu_tree),
             "nu": params_from_flax(nu_tree)}
    if learning_rate is not None:
        state["learning_rate"] = float(np.asarray(learning_rate, dtype=np.float64))
    return state


def opt_state_to_optax(state: dict):
    """``ops.adam.Adam.state_dict()`` -> (count, mu tree, nu tree) of numpy
    arrays in the flax layout."""
    return int(state["count"]), params_to_flax(state["mu"]), params_to_flax(state["nu"])


def _flax_path(name: str):
    """(flax path, permutation from the flax leaf to the torch tensor) of a
    state-dict key; a key that is not the port's ``part.layers.layer.leaf``
    is a flax leaf of its own name and layout."""
    parts = name.split(".")
    if len(parts) == 4 and parts[0] in ("encoder", "decoder") and parts[1] == "layers":
        part, _layers, layer, leaf = parts
        if leaf == "weight":
            return (part, layer, "kernel"), _perm(layer)
        return (part, layer, leaf), None
    return (name,), None


def flax_leaf_layout(names, ndims=None):
    """({name: index in the flattened flax tree}, {name: flax axis of each
    torch dim}) for state-dict keys; ``ndims`` ({name: ndim}) gives the axes
    of keys whose permutation their name does not fix (default: 1)."""
    paths = {n: _flax_path(n) for n in names}
    order = sorted(names, key=lambda n: paths[n][0])
    axes = {}
    for n, (_path, perm) in paths.items():
        axes[n] = tuple(perm) if perm is not None else tuple(range((ndims or {}).get(n, 1)))
    return {n: i for i, n in enumerate(order)}, axes


def fp8_moments_from_optax(entries: dict, names) -> Dict[str, object]:
    """``adam_fp8``'s moment list (``{'0': array or {q, scale, scale_next}, ...}``,
    as orbax stores it) -> {state-dict key: tensor or {q, scale, scale_next}}
    in the port's layout."""
    index, _ = flax_leaf_layout(names)
    out: Dict[str, object] = {}
    for name, i in index.items():
        perm = _flax_path(name)[1]
        entry = entries[str(i)]

        def cross(a):
            a = np.asarray(a)
            return _tensor(a.transpose(perm) if perm is not None else a)

        out[name] = ({f: cross(entry[f]) for f in ("q", "scale", "scale_next")}
                     if isinstance(entry, dict) else cross(entry))
    return out


def fp8_moments_to_optax(moments: dict) -> list:
    """{state-dict key: tensor or {q, scale, scale_next}} -> the list in flax
    order, each array in the flax layout (bfloat16 widened to float32)."""
    index, _ = flax_leaf_layout(moments)
    out = [None] * len(index)
    for name, i in index.items():
        perm = _flax_path(name)[1]

        def cross(t):
            a = t.detach().to("cpu")
            a = (a.to(torch.float32) if a.dtype == torch.bfloat16 else a).numpy()
            return np.ascontiguousarray(a.transpose(_inverse(perm)) if perm is not None else a)

        m = moments[name]
        out[i] = {f: cross(t) for f, t in m.items()} if isinstance(m, dict) else cross(m)
    return out


def qparams_from_flax(tree: dict) -> dict:
    """The JAX package's quantized tree (``quantize_params`` output as numpy
    arrays) -> the port's serving tree of CPU tensors."""
    out: dict = {"encoder": {}, "decoder": {}}
    for part in ("encoder", "decoder"):
        for layer, leaves in tree[part].items():
            entry = {}
            for leaf, arr in leaves.items():
                a = np.asarray(arr)
                if leaf in ("kernel", "kernel_i8"):
                    a = a.transpose(_perm(layer))
                    leaf = "weight" if leaf == "kernel" else leaf
                elif leaf not in ("bias", "scale"):
                    raise KeyError(f"unknown leaf {part}/{layer}/{leaf}")
                entry[leaf] = _tensor(a)
            out[part][layer] = entry
    return out


def qparams_to_flax(tree: dict) -> dict:
    """The port's serving tree -> the JAX package's quantized tree of numpy
    arrays (float32 for bf16 leaves), as its ``call_quantized`` takes it."""
    out: dict = {"encoder": {}, "decoder": {}}
    for part in ("encoder", "decoder"):
        for layer, leaves in tree[part].items():
            entry = {}
            for leaf, t in leaves.items():
                a = t.detach().to("cpu")
                if a.dtype == torch.bfloat16:
                    a = a.to(torch.float32)
                a = a.numpy()
                if leaf in ("weight", "kernel_i8"):
                    a = np.ascontiguousarray(a.transpose(_inverse(_perm(layer))))
                    leaf = "kernel" if leaf == "weight" else leaf
                else:
                    a = a.copy()
                entry[leaf] = a
            out[part][layer] = entry
    return out
