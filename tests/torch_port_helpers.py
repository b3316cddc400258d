"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py):
tiny configs, the same weights in the JAX core and the port, and the two
stateful models side by side with the JAX step's latent noise reproduced."""

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


LOSS_KEYS = ["loss", "mse", "z_l1", "var_loss", "skew_loss", "z_kurtosis_loss", "z_kurtosis",
             "r_min", "r_max", "cross_entropy", "kl_div", "x_std_loss"]
#: the metric dict's keys, in the order the JAX core builds them, per model type
LOSS_KEYS_BY_TYPE = {
    "KurtosisGlobal": LOSS_KEYS,
    "KurtosisSingle": ["loss", "mse", "z_l1", "z_l2", "skew_loss", "z_kurtosis_loss",
                       "z_kurtosis", "r_min", "r_max", "x_std_loss"],
    "KLGaussian": ["loss", "mse", "kl_div", "z_l1", "r_min", "r_max", "x_std_loss"],
}


def typed_config(model_type, **kwargs):
    """``tiny_config`` for ``model_type`` with every optimized loss term of
    that type switched on."""
    cfg = tiny_config(model_type=model_type, **kwargs)
    cfg["loss"].update(w_kurtosis=1e-2, w_skew=5e-3, w_z_l1_reg=1e-3, w_kl_divergence=1e-3)
    return cfg


def paired_models(config, seed=0, compile=True):
    """(JAX VAEModel, the port's VAEModel) on the CPU carrying the same
    weights (the JAX model's seeded init, through the bridge); the model type
    is the config's ``model.type``."""
    from trustedai_cl_vae_ad_tpu.models.wrapper import VAEModel as JaxVAEModel
    from trustedai_cl_vae_ad_tpu.registry import build_core_from_config

    jmodel = JaxVAEModel(build_core_from_config(config), seed=seed)
    tmodel = torch_model_like(config, jmodel.params)
    if compile:
        jmodel.compile()
        tmodel.compile()
    return jmodel, tmodel


def next_jax_eps(jmodel, batch):
    """The latent eps the JAX model's NEXT ``train_step`` will draw, as a
    numpy array (B, latent): that step splits ``jmodel._rng`` once and hands
    the sub-key to ``reparameterize``, which draws
    ``jax.random.normal(key, (B, latent), float32)``. Reads the key without
    advancing it."""
    import jax.numpy as jnp

    _, sub = jax.random.split(jmodel._rng)
    return np.array(jax.random.normal(sub, (batch, jmodel.latent_size), jnp.float32))


def loss_to_np(loss):
    """A loss dict of either package -> {key: float}, in its own key order."""
    return {k: float(np.asarray(to_np(v))) for k, v in loss.items()}
