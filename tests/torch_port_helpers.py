"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py):
tiny configs, and the same weights in the JAX core and the port."""

import jax
import numpy as np
import torch


def tiny_config(image=(32, 48, 3), layers=(4, 8), latent=8, ddf=4, edf=None,
                precision=None, model_type="KurtosisGlobal"):
    model = {"type": model_type, "decoder_dense_filters": ddf,
             "latent_dimensions": latent, "layers": list(layers)}
    if edf:
        model["encoder_dense_filters"] = edf
    training = {"batch_size": 8, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1}
    if precision:
        training["precision"] = precision
    return {
        "data": {"image_size": list(image)},
        "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-4,
                 "w_mse": 1.0, "w_skew": 0.0, "w_z_l1_reg": 0.0},
        "model": model,
        "training": training,
    }


def jax_core_and_params(config, seed=0):
    from trustedai_cl_vae_ad_tpu.registry import build_core_from_config

    core = build_core_from_config(config)
    return core, core.init(jax.random.PRNGKey(seed))


def torch_model_like(config, flax_params, device="cpu"):
    """The port's model carrying the JAX params (via the weight bridge)."""
    from trustedai_cl_vae_ad_tpu_torch.bridge import params_from_flax
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    model = load_model_from_config(config, seed=123, device=device)
    model.core.load_state_dict(params_from_flax(jax.device_get(flax_params)))
    return model


def to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)
