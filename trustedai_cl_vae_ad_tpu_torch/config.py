"""YAML config I/O for the port.

Counterpart of ``load_config`` and ``validate_config`` in
``trustedai_cl_vae_ad_tpu/config.py``: the same 4-section schema (``data``
/ ``loss`` / ``model`` / ``training``), read with PyYAML's ``safe_load``.
The port does not import that module: importing anything of the JAX package
runs its ``__init__``, which imports jax when a ``TCVAE_*`` override is set.
"""

from __future__ import annotations

import os

import yaml

_REQUIRED_SECTIONS = ("data", "loss", "model", "training")


def load_config(config_filename: str) -> dict:
    """Load a YAML config file."""
    if not os.path.isfile(config_filename):
        raise FileNotFoundError(config_filename)
    with open(config_filename, "r") as ifile:
        return yaml.safe_load(ifile)


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
