"""Model-type registry and config loaders for the port.

Counterpart of ``trustedai_cl_vae_ad_tpu/registry.py``: the same three type
names, KurtosisGlobal as the default, the same precision modes. The three
types share the CVAE's encoder, decoder and parameter tree; the type selects
the loss (``models/kurtosis_global.py``, ``models/kurtosis_single.py``,
``models/kl_gaussian.py``).
"""

from __future__ import annotations

import os
from copy import deepcopy

import torch

from trustedai_cl_vae_ad_tpu_torch.config import load_config, validate_config
from trustedai_cl_vae_ad_tpu_torch.models.cvae import AbstractCVAE
from trustedai_cl_vae_ad_tpu_torch.models.kl_gaussian import KLGaussianCVAE
from trustedai_cl_vae_ad_tpu_torch.models.kurtosis_global import KurtosisGlobalCVAE
from trustedai_cl_vae_ad_tpu_torch.models.kurtosis_single import KurtosisSingleCVAE

AVAILABLE_TYPES = [
    "KLGaussian",
    "KurtosisGlobal",
    "KurtosisSingle",
]


_TYPES = {
    "klgaussian": KLGaussianCVAE,
    "kurtosisglobal": KurtosisGlobalCVAE,
    "kurtosissingle": KurtosisSingleCVAE,
}


def import_vae_based_on_type(vae_type: str | None):
    """Resolve a model class by config['model']['type']."""
    if vae_type is None:
        return KurtosisGlobalCVAE
    if vae_type not in AVAILABLE_TYPES:
        raise Exception(
            f"Error, type {vae_type} not found in available types: {AVAILABLE_TYPES}"
        )
    return _TYPES[vae_type.lower()]


def resolve_precision(config: dict):
    """(compute dtype, param dtype) from config['training']['precision']:
    float32 (default), bfloat16, or mixed (f32 params, bf16 compute)."""
    precision = str(config.get("training", {}).get("precision", "float32")).lower()
    if precision in ("bfloat16", "bf16"):
        return torch.bfloat16, torch.bfloat16
    elif precision == "mixed":
        return torch.bfloat16, torch.float32
    elif precision in ("float32", "f32", "fp32"):
        return torch.float32, torch.float32
    raise ValueError(
        f"Unknown training.precision {precision!r}: "
        f"use float32, bfloat16, or mixed"
    )


def use_full_float32() -> None:
    """Make float32 mean float32 on the card. cuDNN convolutions default to
    TF32 (about three decimal digits); cuBLAS matmuls do not, but say so
    explicitly. This is the one place the port sets either flag, and it is
    process-wide: every float32 model built by ``build_core_from_config``
    turns TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_core_from_config(config: dict, device="meta") -> AbstractCVAE:
    """The CVAE module. On the default ``meta`` device no parameter memory
    is allocated; ``load_model_from_config`` materializes and seeds it."""
    core_cls = import_vae_based_on_type(config["model"].get("type"))
    dtype, param_dtype = resolve_precision(config)
    if dtype == torch.float32:
        use_full_float32()
    return core_cls(deepcopy(config), dtype=dtype, param_dtype=param_dtype, device=device)


def load_model_from_config(config: dict, seed: int = 0, device="cuda"):
    """The stateful wrapper with fresh random params, drawn on ``device``
    from ``seed``. The card is the default; the CPU is for callers that ask
    for it (``device="cpu"``), as the tests do."""
    from trustedai_cl_vae_ad_tpu_torch.models.wrapper import VAEModel

    device = torch.device(device)
    core = build_core_from_config(config).to_empty(device=device)
    core.init_params(seed)
    return VAEModel(core, device, seed=seed)


def load_model_from_config_path(config_path: str, seed: int = 0, device="cuda"):
    config = validate_config(load_config(config_path))
    return load_model_from_config(config, seed=seed, device=device), config


def load_model_from_directory(logdir: str, device="cuda", restore_optimizer=False):
    """(model, config) from a log directory that this package's ``save_model``
    or the JAX package's wrote: ``config.yml`` beside ``encoder/`` and
    ``decoder/`` (``train/checkpoint.py`` reads either layout). The weights
    are restored. ``restore_optimizer=True`` also compiles the model and
    restores checkpointed Adam moments, when the directory holds them (a
    resume of training or of continual learning); the default allocates
    none."""
    config_path = os.path.join(logdir, "config.yml")
    if not os.path.isfile(config_path):
        raise FileNotFoundError(f"{config_path} not found: not a training log directory")
    model, config = load_model_from_config_path(config_path, device=device)
    model.load_model(logdir, restore_optimizer=bool(restore_optimizer))
    return model, config
