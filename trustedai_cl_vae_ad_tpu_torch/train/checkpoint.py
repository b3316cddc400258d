"""Checkpoints in the logdir layout's stable names.

Counterpart of the stable-name part of ``trustedai_cl_vae_ad_tpu/train/
checkpoint.py``: a log directory holds

    <logdir>/encoder/params.pt     {state-dict key: tensor} of the encoder
    <logdir>/decoder/params.pt     the same for the decoder
    <logdir>/optimizer/state.pt    {"count", "mu/<key>", "nu/<key>"} (optional)

beside ``config.yml`` and ``train_state.json``. Each file is a plain dict of
CPU tensors written by ``torch.save`` to a temporary name and moved into
place with ``os.replace``, and read with ``torch.load(weights_only=True)``,
which unpickles tensors and plain containers only. Limits of the format: the
files are PyTorch's own, not the JAX package's orbax trees (reading those,
the crash-atomic ``rounds/`` + ``current`` layout and the asynchronous saver
are ROADMAP queue 1 item 8); a save replaces one file at a time, so a crash
between files can leave parts from two saves.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

PARTS = ("encoder", "decoder")
PARAMS_FILE = "params.pt"
OPTIMIZER_DIR = "optimizer"
OPTIMIZER_FILE = "state.pt"


def _save_atomic(obj: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu") for k, v in tensors.items()}


def save_checkpoint(logdir: str, params: Dict[str, torch.Tensor],
                    opt_state: Optional[dict] = None) -> None:
    """Write the weights (and the optimizer state, when given) under
    ``logdir``. One part is on the host at a time."""
    for part in PARTS:
        sub = {k: v for k, v in params.items() if k.startswith(part + ".")}
        if not sub:
            raise KeyError(f"no parameters named {part}.* to save")
        _save_atomic(_to_host(sub), os.path.join(logdir, part, PARAMS_FILE))
    if opt_state is not None:
        flat = {"count": torch.tensor(int(opt_state["count"]), dtype=torch.int64)}
        for kind in ("mu", "nu"):
            flat.update({f"{kind}/{k}": v for k, v in _to_host(opt_state[kind]).items()})
        _save_atomic(flat, os.path.join(logdir, OPTIMIZER_DIR, OPTIMIZER_FILE))


def has_optimizer(logdir: str) -> bool:
    return os.path.isfile(os.path.join(logdir, OPTIMIZER_DIR, OPTIMIZER_FILE))


def _load(path: str, map_location) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} not found: not a log directory written by this package's save_model")
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_params(logdir: str, map_location="cpu") -> Dict[str, torch.Tensor]:
    """The full state dict of the core from ``logdir``."""
    out: Dict[str, torch.Tensor] = {}
    for part in PARTS:
        out.update(_load(os.path.join(logdir, part, PARAMS_FILE), map_location))
    return out


def restore_optimizer_state(logdir: str, map_location="cpu") -> dict:
    """{'count', 'mu', 'nu'} as ``ops.adam.Adam.load_state_dict`` takes it."""
    flat = _load(os.path.join(logdir, OPTIMIZER_DIR, OPTIMIZER_FILE), map_location)
    state: dict = {"count": int(flat["count"]), "mu": {}, "nu": {}}
    for key, t in flat.items():
        if key != "count":
            kind, name = key.split("/", 1)
            state[kind][name] = t
    return state
