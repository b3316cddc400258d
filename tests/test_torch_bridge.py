"""Weight bridge (flax tree <-> state dict) and the conv geometry it relies on,
pinned against lax / flax."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import jax_core_and_params, tiny_config


def test_round_trip_is_exact():
    from trustedai_cl_vae_ad_tpu_torch.bridge import params_from_flax, params_to_flax
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    config = tiny_config(image=(30, 45, 3), edf=6)
    _, params = jax_core_and_params(config)
    tree = jax.device_get(params)
    sd = params_from_flax(tree)
    back = params_to_flax(sd)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(back)) == 16
    for path, leaf in flat:
        keys = [p.key for p in path]
        np.testing.assert_array_equal(back[keys[0]][keys[1]][keys[2]], np.asarray(leaf))
    # the state dict loads into the port's model under the flax names
    model = load_model_from_config(config, seed=1)
    model.core.load_state_dict(sd)
    assert "encoder.layers.Dense_1.weight" in model.params
    again = params_to_flax(model.params)
    np.testing.assert_array_equal(again["decoder"]["ConvTranspose_2"]["kernel"],
                                  np.asarray(tree["decoder"]["ConvTranspose_2"]["kernel"]))


def test_layouts():
    from trustedai_cl_vae_ad_tpu_torch.bridge import params_from_flax

    config = tiny_config()
    _, params = jax_core_and_params(config)
    tree = jax.device_get(params)
    sd = params_from_flax(tree)
    conv = np.asarray(tree["encoder"]["Conv_1"]["kernel"])  # HWIO
    assert sd["encoder.layers.Conv_1.weight"].shape == (conv.shape[3], conv.shape[2], 3, 3)
    dense = np.asarray(tree["decoder"]["Dense_0"]["kernel"])  # (in, out)
    np.testing.assert_array_equal(sd["decoder.layers.Dense_0.weight"].numpy(), dense.T)
    convt = np.asarray(tree["decoder"]["ConvTranspose_0"]["kernel"])  # (kh, kw, out, in)
    np.testing.assert_array_equal(sd["decoder.layers.ConvTranspose_0.weight"].numpy(),
                                  convt.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(6, 8), (5, 7)], ids=["even", "odd"])
def test_conv_transpose_mapping_pinned(stride, hw):
    """flax ConvTranspose(transpose_kernel=True, SAME) == the port's
    conv_transpose_same on P.permute(3, 2, 0, 1), with no spatial flip; the
    usual torch padding (padding=1, output_padding=1) is off for stride 2."""
    from trustedai_cl_vae_ad_tpu_torch.ops.convt import conv_transpose_same

    rng = np.random.RandomState(stride * 10 + hw[0])
    x = rng.normal(size=(2, *hw, 4)).astype(np.float32)
    P = rng.normal(size=(3, 3, 5, 4)).astype(np.float32)  # (kh, kw, out, in)
    m = nn.ConvTranspose(features=5, kernel_size=(3, 3), strides=(stride, stride),
                         padding="SAME", transpose_kernel=True, use_bias=False)
    ref = np.asarray(m.apply({"params": {"kernel": jnp.asarray(P)}}, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w = torch.from_numpy(P).permute(3, 2, 0, 1)
    got = conv_transpose_same(xt, w, stride).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, hw[0] * stride, hw[1] * stride, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    flipped = conv_transpose_same(xt, w.flip(2, 3), stride).permute(0, 2, 3, 1).numpy()
    assert np.max(np.abs(flipped - ref)) > 1e-2
    if stride == 2:
        usual = F.conv_transpose2d(xt, w, stride=2, padding=1, output_padding=1)
        assert np.max(np.abs(usual.permute(0, 2, 3, 1).numpy() - ref)) > 1e-2


@pytest.mark.parametrize("hw", [(8, 10), (7, 9)], ids=["even", "odd"])
def test_strided_same_conv_pinned(hw):
    """TF-SAME stride-2 conv (pad top 0 / bottom 1 on even inputs) ==
    lax.conv_general_dilated 'SAME'; torch's padding=1 differs on even inputs."""
    from trustedai_cl_vae_ad_tpu_torch.models.cvae import conv2d_same

    rng = np.random.RandomState(hw[0])
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)  # HWIO
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1)
    got = conv2d_same(xt, wt, None, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    sym = F.conv2d(xt, wt, stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    if hw[0] % 2 == 0:
        assert np.max(np.abs(sym - ref)) > 1e-2
    else:
        np.testing.assert_allclose(sym, ref, rtol=1e-5, atol=1e-5)
