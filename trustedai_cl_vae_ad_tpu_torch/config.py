"""YAML config I/O for the port.

Counterpart of ``trustedai_cl_vae_ad_tpu/config.py``: the same 4-section
schema (``data`` / ``loss`` / ``model`` / ``training`` plus a ``logdir``
injected at run time), read and written with PyYAML's ``safe_load`` and
``safe_dump``, and the ``logs/fit_<timestamp>`` log-directory stamping.
The port does not import that module: importing anything of the JAX package
runs its ``__init__``, which imports jax when a ``TCVAE_*`` override is set.
"""

from __future__ import annotations

import datetime
import os
from typing import Any

import yaml

_REQUIRED_SECTIONS = ("data", "loss", "model", "training")


def load_config(config_filename: str) -> dict:
    """Load a YAML config file."""
    if not os.path.isfile(config_filename):
        raise FileNotFoundError(config_filename)
    with open(config_filename, "r") as ifile:
        return yaml.safe_load(ifile)


def save_config(config: dict, config_filename: str) -> None:
    """Persist a config dict as YAML."""
    with open(config_filename, "w") as ofile:
        yaml.safe_dump(_plain(config), ofile)


def _plain(obj: Any) -> Any:
    """Coerce numpy / torch scalars into YAML-safe builtins."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except (TypeError, ValueError, RuntimeError):  # not a one-element value
            return obj
    return obj


def stamp_logdir(config: dict, base_dir: str = "./logs", prefix: str = "fit") -> dict:
    """Create logs/<prefix>_<timestamp>, inject it into the config as
    ``logdir``, and copy the config there."""
    logdir = os.path.abspath(
        os.path.join(base_dir, f"{prefix}_{datetime.datetime.now().strftime('%Y%m%d-%H%M%S')}")
    )
    os.makedirs(logdir, exist_ok=True)
    config["logdir"] = logdir
    save_config(config, os.path.join(logdir, "config.yml"))
    return config


def validate_config(config: dict) -> dict:
    """Light schema validation for the 4-section YAML; returns the config
    unchanged. Raises ValueError naming the missing key."""
    for section in _REQUIRED_SECTIONS:
        if section not in config:
            raise ValueError(f"config missing required section '{section}'")
    model = config["model"]
    if "latent_dimensions" not in model:
        raise ValueError("config['model'] missing 'latent_dimensions'")
    if "layers" not in model or not model["layers"]:
        raise ValueError("config['model'] missing non-empty 'layers'")
    if "decoder_dense_filters" not in model:
        raise ValueError("config['model'] missing 'decoder_dense_filters'")
    data = config["data"]
    if "image_size" not in data or len(data["image_size"]) != 3:
        raise ValueError("config['data']['image_size'] must be [W, H, C]")
    return config
