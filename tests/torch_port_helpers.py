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


def np_to_torch_exact(a):
    """A numpy array as JAX gives it -> a CPU tensor that owns its memory, bit
    for bit; bfloat16 (``ml_dtypes``) stays bfloat16."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def torch_to_np_exact(t):
    """The inverse of ``np_to_torch_exact``: bfloat16 comes back as
    ``ml_dtypes.bfloat16``."""
    import ml_dtypes

    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def load_r11_probes(monkeypatch, tmp_path):
    """The archived JAX probes ``benchmarks/r11_kernel.py`` and ``r11_diag.py``
    (and the harness ``r11_fused_dense_adam.py``) as fresh modules whose Pallas
    kernels run in interpret mode on the CPU; returns (r11_kernel, r11_diag,
    calls, r11_fused_dense_adam), ``calls`` growing by one per ``pallas_call``. Nothing of it outlives the test: the modules leave
    ``sys.modules``, ``sys.path`` and the environment are restored, and the
    compile-cache variable that importing ``r11_diag`` would set (a
    ``TCVAE_*`` override, which other tests read) points into ``tmp_path``."""
    import importlib.util
    import os
    import sys

    from jax.experimental import pallas as pl

    benchmarks = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "benchmarks")
    monkeypatch.setenv("TCVAE_COMPILE_CACHE", str(tmp_path / "xla_cache"))
    monkeypatch.syspath_prepend(benchmarks)  # restores all of sys.path afterwards
    mods = []
    for name in ("r11_kernel", "r11_diag", "r11_fused_dense_adam"):
        spec = importlib.util.spec_from_file_location(name, os.path.join(benchmarks, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        monkeypatch.setitem(sys.modules, name, mod)  # r11_diag imports r11_kernel by name
        spec.loader.exec_module(mod)
        mods.append(mod)
    kernel, diag, fused = mods
    monkeypatch.setattr(kernel, "_INTERPRET", True)
    calls = []
    pallas_call = pl.pallas_call

    def interpreted(*args, **kwargs):
        calls.append(1)
        kwargs["interpret"] = True
        return pallas_call(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    return kernel, diag, calls, fused


def load_r18_probe(monkeypatch, tmp_path):
    """The archived JAX probe ``benchmarks/r18_conv_dw.py`` as a fresh module
    whose Pallas kernel runs in interpret mode on the CPU. The file sets
    ``TCVAE_COMPILE_CACHE`` and ``TCVAE_COMPILER_OPTIONS`` (TPU compiler
    options, which the JAX package's jits would then pass on) where they are
    unset: both are set beforehand, the cache into ``tmp_path`` and the
    options to nothing, and restored after the test, as is ``sys.path``; the
    module never enters ``sys.modules``."""
    import importlib.util
    import os

    benchmarks = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "benchmarks")
    monkeypatch.setenv("TCVAE_COMPILE_CACHE", str(tmp_path / "xla_cache"))
    monkeypatch.setenv("TCVAE_COMPILER_OPTIONS", "")
    monkeypatch.syspath_prepend(benchmarks)  # restores all of sys.path afterwards
    spec = importlib.util.spec_from_file_location(
        "r18_conv_dw_archived", os.path.join(benchmarks, "r18_conv_dw.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "_INTERPRET", True)
    return mod


def assert_one_step_apart(got, ref, label, share=0.01, terms=None, updates=1):
    """``got`` and ``ref`` (numpy, one dtype, bfloat16 or float32) are equal
    except on at most ``share`` of their elements, which differ by at most
    ``updates`` steps of that dtype as ``testing.steps_apart`` counts them
    (``terms`` as there). ``updates`` is how many updates the values went
    through, each of which may add one such step."""
    from trustedai_cl_vae_ad_tpu_torch.testing import steps_apart

    assert got.dtype == ref.dtype, (label, got.dtype, ref.dtype)
    differing, worst = steps_apart(
        np_to_torch_exact(got), np_to_torch_exact(ref),
        None if terms is None else torch.from_numpy(np.asarray(terms, np.float64)))
    assert worst <= updates, (label, worst)
    assert differing <= share, (label, differing)
    return differing
