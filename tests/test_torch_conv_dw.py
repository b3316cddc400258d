"""``ops/conv_dw.py`` on the CPU against the archived JAX probe
``benchmarks/r18_conv_dw.py`` (its Pallas kernel in interpret mode): the plain
version of the weight gradient, the autograd Function that routes a
convolution's weight gradient through it, the HWIO -> OIHW map, what the
wrapper refuses, and that the CPU path never counts a launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import load_r18_probe, np_to_torch_exact
from trustedai_cl_vae_ad_tpu_torch.bridge import params_from_flax
from trustedai_cl_vae_ad_tpu_torch.models.cvae import conv2d_same
from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw
from trustedai_cl_vae_ad_tpu_torch.probes import r18

# (B, H, W, CI, CO): the archived check's two shapes, a batch of 1, CI = 1
SHAPES = [(2, 8, 12, 3, 8), (3, 16, 16, 5, 4), (1, 4, 6, 3, 2), (2, 6, 8, 1, 4)]
IDS = ["check-3to8", "check-5to4", "batch1", "ci1"]
TOL = dict(rtol=1e-4, atol=1e-4)  # the archived check's


def _operands(shape, seed=0):
    return r18.check_operands(shape, seed=seed)


@pytest.fixture
def probe(monkeypatch, tmp_path):
    return load_r18_probe(monkeypatch, tmp_path)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_reference_equals_the_pallas_kernel_float32(probe, shape):
    x, _w, dy = _operands(shape)
    before = cdw.launches
    got = cdw.conv_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert cdw.launches == before  # the CPU path is the plain version
    want = np.asarray(probe.conv_dw_pallas(jnp.asarray(x), jnp.asarray(dy)))
    assert got.shape == want.shape == (3, 3, shape[3], shape[4]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, cdw.conv_dw_reference(torch.from_numpy(x), torch.from_numpy(dy)))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_reference_equals_the_pallas_kernel_bfloat16_inputs(probe, shape):
    """Both get the same bfloat16 operands; products of bfloat16 values are
    exact in float32, so only the order of the float32 sums differs."""
    x, _w, dy = _operands(shape, seed=1)
    xj, dyj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    want = np.asarray(probe.conv_dw_pallas(xj, dyj))
    got = cdw.conv_dw(np_to_torch_exact(np.asarray(xj)), np_to_torch_exact(np.asarray(dyj)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_reference_equals_jax_grad_of_the_convolution(probe, shape):
    x, w, dy = _operands(shape, seed=2)
    want = jax.grad(lambda kk: jnp.sum(probe._conv_fwd(jnp.asarray(x), kk) * dy))(jnp.asarray(w))
    got = cdw.conv_dw_reference(torch.from_numpy(x), torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_function_equals_the_jax_custom_vjp_and_autograd(probe, shape):
    """Forward, dx and dW of ``conv2d_s2_kernel_dw`` against the JAX
    ``conv2d_s2_pallas_dw`` and against autograd of the port's own
    ``conv2d_same``."""
    x, w, dy = _operands(shape, seed=3)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    y_jax = np.asarray(probe.conv2d_s2_pallas_dw(xj, wj))
    gx, gw = jax.grad(lambda xx, kk: jnp.sum(probe.conv2d_s2_pallas_dw(xx, kk) * dy),
                      argnums=(0, 1))(xj, wj)

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    before = cdw.launches
    y = cdw.conv2d_s2_kernel_dw(xt, wt)
    (y * torch.from_numpy(dy)).sum().backward()
    assert cdw.launches == before
    assert y.shape == y_jax.shape and xt.grad.shape == x.shape and wt.grad.shape == w.shape
    np.testing.assert_allclose(y.detach().numpy(), y_jax, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **TOL)

    ref_dx, ref_dw = r18.autograd_gradients(torch.from_numpy(x), torch.from_numpy(w),
                                            torch.from_numpy(dy))
    torch.testing.assert_close(xt.grad, ref_dx, **TOL)
    torch.testing.assert_close(wt.grad, ref_dw, **TOL)


def test_function_casts_dw_to_the_weights_dtype_and_skips_unneeded_gradients():
    x, w, dy = (torch.from_numpy(a) for a in _operands(SHAPES[0], seed=4))
    xb, wb = x.bfloat16(), w.bfloat16().requires_grad_(True)
    y = cdw.conv2d_s2_kernel_dw(xb, wb)  # x needs no gradient: no data gradient is taken
    (y * dy.bfloat16()).sum().backward()
    assert wb.grad.dtype == torch.bfloat16 and y.dtype == torch.bfloat16
    want = cdw.conv_dw_reference(xb, dy.bfloat16()).to(torch.bfloat16)
    assert torch.equal(wb.grad, want)
    xr = x.clone().requires_grad_(True)
    cdw.conv2d_s2_kernel_dw(xr, w).sum().backward()  # and the weight alone may need none
    assert xr.grad is not None and w.grad is None


def test_function_takes_permuted_views_of_nchw_activations_and_conv2d_weights():
    """What the probe's encoder hands it: an NHWC view of NCHW memory and an
    HWIO view of an ``nn.Conv2d.weight``. The operand in another memory order
    is copied, and the copy is counted."""
    x, w, dy = (torch.from_numpy(a) for a in _operands(SHAPES[1], seed=5))
    conv = torch.nn.Conv2d(5, 4, 3, stride=2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(cdw.dw_to_oihw(w))
    x_nchw = x.permute(0, 3, 1, 2).contiguous().requires_grad_(True)  # NCHW memory
    copied = cdw.copied_bytes
    y = cdw.conv2d_s2_kernel_dw(x_nchw.permute(0, 2, 3, 1), conv.weight.permute(2, 3, 1, 0))
    (y * dy).sum().backward()
    assert cdw.copied_bytes >= copied + x.numel() * 4
    ref_dx, ref_dw = r18.autograd_gradients(x, w, dy)
    torch.testing.assert_close(conv.weight.grad, cdw.dw_to_oihw(ref_dw), **TOL)
    torch.testing.assert_close(x_nchw.grad, ref_dx.permute(0, 3, 1, 2), **TOL)


def test_dw_maps_onto_conv2d_weight_as_the_bridge_maps_kernels():
    """``dw_to_oihw`` is the bridge's HWIO -> OIHW map: the mapped gradient
    is the gradient of the mapped weight."""
    x, w, dy = (torch.from_numpy(a) for a in _operands(SHAPES[0], seed=6))
    tree = {"encoder": {"Conv_0": {"kernel": w.numpy(), "bias": np.zeros(8, np.float32)}},
            "decoder": {}}
    weight = params_from_flax(tree)["encoder.layers.Conv_0.weight"]
    assert torch.equal(weight, cdw.dw_to_oihw(w)) and weight.shape == (8, 3, 3, 3)
    weight = weight.clone().requires_grad_(True)
    y = conv2d_same(x.permute(0, 3, 1, 2), weight, None, 2)
    (y.permute(0, 2, 3, 1) * dy).sum().backward()
    torch.testing.assert_close(cdw.dw_to_oihw(cdw.conv_dw(x, dy)), weight.grad, **TOL)


def test_the_padding_is_one_row_below_and_one_column_right():
    """Only the taps (kh, kw) = (2, .) and (., 2) ever read the padding: with
    an x that is zero except its last row and column, dW is zero there."""
    x = torch.zeros(1, 4, 6, 1)
    x[0, 3, :, 0] = 1.0
    x[0, :, 5, 0] = 1.0
    dy = torch.zeros(1, 2, 3, 1)
    dy[0, 1, 2, 0] = 1.0  # the last output position: its taps cover rows 2..4, columns 4..6
    dw = cdw.conv_dw(x, dy)[:, :, 0, 0]
    assert dw.tolist() == [[0.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]]


BAD = [
    ("odd H", lambda x, dy: (x[:, :7], dy), ValueError),
    ("odd W", lambda x, dy: (x[:, :, :11].contiguous(), dy), ValueError),
    ("mixed dtypes", lambda x, dy: (x.bfloat16(), dy), TypeError),
    ("float64", lambda x, dy: (x.double(), dy.double()), TypeError),
    ("a non-contiguous x", lambda x, dy: (x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                                          dy), ValueError),
    ("a non-contiguous dy", lambda x, dy: (x, dy.transpose(1, 2).contiguous().transpose(1, 2)),
     ValueError),
    ("a dy of another size", lambda x, dy: (x, dy[:, :3].contiguous()), ValueError),
    ("a dy of another batch", lambda x, dy: (x, dy[:1]), ValueError),
    ("a 3-d x", lambda x, dy: (x[0], dy), ValueError),
    ("an empty batch", lambda x, dy: (x[:0], dy[:0]), ValueError),
]


@pytest.mark.parametrize("what,make,error", BAD, ids=[b[0] for b in BAD])
def test_bad_operands_raise(what, make, error):
    x, _w, dy = (torch.from_numpy(a) for a in _operands(SHAPES[0]))
    with pytest.raises(error):
        cdw.conv_dw(*make(x, dy))


def test_function_refuses_odd_sizes_and_other_kernels():
    x, w, _dy = (torch.from_numpy(a) for a in _operands(SHAPES[0]))
    with pytest.raises(ValueError, match="even"):
        cdw.conv2d_s2_kernel_dw(x[:, :7], w)
    with pytest.raises(ValueError, match="3, 3, CI, CO"):
        cdw.conv2d_s2_kernel_dw(x, w[:2])
    with pytest.raises(ValueError, match="3, 3, CI, CO"):
        cdw.conv2d_s2_kernel_dw(x, cdw.dw_to_oihw(w))  # an OIHW weight
    with pytest.raises(TypeError):
        cdw.conv2d_s2_kernel_dw(x.bfloat16(), w)


def test_a_cuda_tensor_without_a_card_raises_instead_of_running_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, 2, 2, 1, device="cuda")
    # and the wrapper dispatches on the tensor's device alone: a tensor of another
    # device type is refused, never carried on the CPU
    with pytest.raises(ValueError, match="cuda and cpu"):
        cdw.conv_dw(torch.zeros(1, 2, 2, 1, device="meta"), torch.zeros(1, 1, 1, 1, device="meta"))
