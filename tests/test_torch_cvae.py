"""Port CVAE forward vs the JAX AbstractCVAE on the same weights and inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_core_and_params, tiny_config, to_np, torch_model_like

CASES = {
    "even": dict(image=(32, 48, 3)),
    "odd-edf": dict(image=(30, 45, 3), edf=6),
    "even-edf": dict(image=(32, 48, 3), edf=5, model_type="KurtosisSingle"),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """(config, JAX core, flax params, port core) with the same weights."""
    config = tiny_config(**CASES[request.param])
    jcore, params = jax_core_and_params(config)
    return config, jcore, params, torch_model_like(config, params).core


def _inputs(shape, kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "uint8":
        return rng.randint(0, 256, (2, *shape), dtype=np.uint8)
    return rng.random((2, *shape)).astype(np.float32)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_forward_matches_jax(pair, kind):
    config, jcore, params, tcore = pair
    x = _inputs(config["data"]["image_size"], kind)
    with torch.no_grad():
        t_mean, t_logvar = tcore.encode(torch.from_numpy(x))
        t_out = tcore.call(torch.from_numpy(x))
    j_mean, j_logvar = jcore.encode(params, jnp.asarray(x))
    np.testing.assert_allclose(to_np(t_mean), np.asarray(j_mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(t_logvar), np.asarray(j_logvar), rtol=1e-5, atol=1e-5)
    j_out = jcore.call(params, jnp.asarray(x), training=False)
    assert t_out.shape == j_out.shape
    assert t_out.is_contiguous()  # NHWC, as the scorer kernel requires
    np.testing.assert_allclose(to_np(t_out), np.asarray(j_out), rtol=1e-5, atol=1e-5)


def test_decode_and_call_detailed_with_injected_eps(pair):
    config, jcore, params, tcore = pair
    rng = np.random.RandomState(1)
    z = rng.normal(size=(3, 8)).astype(np.float32)
    with torch.no_grad():
        t_logits = tcore.decode(torch.from_numpy(z))
        t_prob = tcore.decode(torch.from_numpy(z), apply_sigmoid=True)
    np.testing.assert_allclose(to_np(t_logits), np.asarray(jcore.decode(params, jnp.asarray(z))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        to_np(t_prob), np.asarray(jcore.decode(params, jnp.asarray(z), apply_sigmoid=True)),
        rtol=1e-5, atol=1e-5)

    x = _inputs(config["data"]["image_size"], "float", seed=2)
    eps = rng.normal(size=(2, 8)).astype(np.float32)
    with torch.no_grad():
        t_prob, t_z, t_mean, t_logvar = tcore.call_detailed(
            torch.from_numpy(x), training=True, eps=torch.from_numpy(eps))
    j_mean, j_logvar = jcore.encode(params, jnp.asarray(x))
    j_z = j_mean + 0.5 * j_logvar + eps  # z = mean + 0.5*logvar + eps
    j_prob = jcore.decode(params, j_z, apply_sigmoid=True)
    for t, j in ((t_prob, j_prob), (t_z, j_z), (t_mean, j_mean), (t_logvar, j_logvar)):
        np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-5, atol=1e-5)
    # eval: eps is zero, as in the JAX core
    with torch.no_grad():
        _, t_z0, t_mean0, t_logvar0 = tcore.call_detailed(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(t_z0), to_np(t_mean0 + 0.5 * t_logvar0), rtol=0, atol=0)


def test_bfloat16_forward_matches_jax():
    config = tiny_config(precision="bfloat16")
    jcore, params = jax_core_and_params(config)
    model = torch_model_like(config, params)
    assert model.core.encoder.layers["Conv_0"].weight.dtype == torch.bfloat16
    x = _inputs(config["data"]["image_size"], "uint8", seed=3)
    t_out = to_np(model.call(x))
    j_out = np.asarray(jcore.call(params, jnp.asarray(x)))
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=3e-2)


@pytest.mark.parametrize("image,axis", [((4, 48, 3), "Width"), ((32, 4, 3), "Height")])
def test_collapse_errors(image, axis):
    from trustedai_cl_vae_ad_tpu.models.cvae import compute_dense_shape as jax_dense_shape
    from trustedai_cl_vae_ad_tpu_torch.models.cvae import compute_dense_shape

    config = tiny_config(image=image, layers=(4, 8, 16))
    with pytest.raises(RuntimeError, match=f"{axis} Collapse"):
        compute_dense_shape(config)
    with pytest.raises(RuntimeError, match=f"{axis} Collapse"):
        jax_dense_shape(config)
    ok = tiny_config(image=(30, 45, 3))
    assert compute_dense_shape(ok) == jax_dense_shape(ok) == (7, 11, 4)


def test_registry_types_precision_and_unported_loss():
    from trustedai_cl_vae_ad_tpu_torch import registry

    assert registry.import_vae_based_on_type(None) is registry.KurtosisGlobalCVAE
    for name in registry.AVAILABLE_TYPES:
        cls = registry.import_vae_based_on_type(name)
        assert cls.reparameterize is registry.AbstractCVAE.reparameterize
    with pytest.raises(Exception, match="not found"):
        registry.import_vae_based_on_type("Nope")
    assert registry.resolve_precision({}) == (torch.float32, torch.float32)
    assert registry.resolve_precision({"training": {"precision": "mixed"}}) == (
        torch.bfloat16, torch.float32)
    with pytest.raises(ValueError):
        registry.resolve_precision({"training": {"precision": "fp8"}})
    core = registry.build_core_from_config(tiny_config())
    assert next(core.parameters()).device.type == "meta"  # nothing allocated
    assert not torch.backends.cudnn.allow_tf32  # float32 means float32
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        core.compute_loss(None)
    # model.s2d_input / model.fast_vjp are accepted and change nothing
    cfg = tiny_config()
    cfg["model"].update(s2d_input=True, fast_vjp=False)
    registry.build_core_from_config(cfg)


def test_seeded_init_is_glorot_and_reproducible():
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    config = tiny_config()
    a = load_model_from_config(config, seed=7).params
    b = load_model_from_config(config, seed=7).params
    c = load_model_from_config(config, seed=8).params
    for k in a:
        assert torch.equal(a[k], b[k])
    w = a["encoder.layers.Dense_0.weight"]  # (16, 768)
    limit = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.9 * limit
    assert not torch.equal(w, c["encoder.layers.Dense_0.weight"])
    assert all(float(a[k].abs().max()) == 0.0 for k in a if k.endswith("bias"))
