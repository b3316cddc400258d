"""The CUDA kernels (stream scorer, global and per-dimension moments) vs their
plain PyTorch versions on the card.

Marked ``cuda``: without a CUDA device these tests skip. On the card run
``python -m pytest tests/test_torch_kernels_gpu.py -q``.
"""

import numpy as np
import pytest
import torch

from trustedai_cl_vae_ad_tpu_torch.testing import (
    STARTS,
    compare_sequences,
    run_sequence,
    score_sequence,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


def _step(fn, dev):
    def run(state, img, rec, alpha):
        state, norm, score, count = fn(state, torch.from_numpy(img).to(dev),
                                       torch.from_numpy(rec).to(dev), alpha)
        return (state, state.maps.cpu().numpy(), state.scalars.cpu().numpy(),
                norm.cpu().numpy(), float(score), float(count))
    return run


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("hwc", [(224, 300, 3), (37, 53, 3)], ids=["224x300", "37x53"])
def test_kernel_matches_plain_version(cuda_device, hwc, start):
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    h, w, c = hwc
    imgs, recs, maps0, scalars0 = score_sequence(h, w, c, 8, seed=h, start=start)

    def state0():
        return ss.StreamScoreState(torch.from_numpy(maps0).to(cuda_device),
                                   torch.from_numpy(scalars0).to(cuda_device))

    before = ss.launches
    got = run_sequence(_step(ss.stream_score_step, cuda_device), state0(), imgs, recs, 0.99)
    assert ss.launches == before + len(imgs)
    ref = run_sequence(_step(ss.stream_score_step_reference, cuda_device), state0(),
                       imgs, recs, 0.99)
    compare_sequences(got, ref, f"{h}x{w}x{c} {start}")
    if start == "constant":
        assert got[0][4] == 0.0 and np.isnan(got[0][3])


def test_kernel_rejects_bad_inputs(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    state = ss.init_state(8, 8, cuda_device)
    img = torch.rand(8, 8, 3, device=cuda_device)
    with pytest.raises(TypeError):
        ss.stream_score_step(state, img.double(), img.double(), 0.9)
    with pytest.raises(ValueError):
        ss.stream_score_step(state, img, img[:4], 0.9)
    with pytest.raises(ValueError):
        ss.stream_score_step(state, img.transpose(0, 1), img, 0.9)
    with pytest.raises(ValueError):
        ss.stream_score_step(state, img, img.cpu(), 0.9)


MOMENT_CASES = [((256, 2000), "float32"), ((768, 2000), "float32"), ((7, 13), "float32"),
                ((256, 2000), "bfloat16"), ((7, 13), "bfloat16")]


@pytest.mark.parametrize("shape, dtype", MOMENT_CASES,
                         ids=[f"{s[0]}x{s[1]}-{d}" for s, d in MOMENT_CASES])
def test_moments_kernel_matches_plain_version(cuda_device, shape, dtype):
    """Forward and backward; rtol 1e-5 on mean and variance, 1e-4 on skew,
    kurtosis and the gradient (the order of the sums differs), with an
    absolute floor where a value is a small difference of large sums."""
    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    z = (torch.randn(shape, device=cuda_device, generator=gen) * 1.3 + 0.4).to(
        getattr(torch, dtype))
    before = (mo.launches, mo.bwd_launches)
    out = mo.global_moments_packed(z)
    ref = torch.stack(mo.global_moments_reference(z))
    torch.testing.assert_close(out[:2], ref[:2], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[2:], ref[2:], rtol=1e-4, atol=1e-6)
    assert torch.equal(out, mo.global_moments_packed(z))  # the same bits from run to run
    gout = torch.tensor([0.3, -0.7, 1.1, 0.9], device=cuda_device)
    grad = mo.global_moments_backward(z, out, gout)
    grad_ref = mo.global_moments_backward_reference(z, out, gout)
    scale = float(grad_ref.float().abs().max())
    torch.testing.assert_close(grad.float(), grad_ref.float(), rtol=1e-4, atol=1e-6 * scale)
    assert grad.dtype == z.dtype
    assert torch.equal(grad, mo.global_moments_backward(z, out, gout))
    assert (mo.launches, mo.bwd_launches) == (before[0] + 2, before[1] + 2)
    # through autograd: one forward and one backward launch, no plain version
    za = z.clone().requires_grad_(True)
    m, var, skew, kurt = mo.global_moments(za)
    (0.3 * m - 0.7 * var + 1.1 * skew + 0.9 * kurt).backward()
    assert (mo.launches, mo.bwd_launches) == (before[0] + 3, before[1] + 3)
    # bfloat16 gradients are rounded to 8 bits
    rtol = 1e-4 if dtype == "float32" else 2.0 ** -7
    torch.testing.assert_close(za.grad.float(), grad_ref.float(), rtol=rtol, atol=rtol * scale)


def test_moments_kernel_constant_input_and_unaligned_views(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo

    const = torch.full((16, 128), 2.0, device=cuda_device)
    out = mo.global_moments_packed(const)
    assert out.tolist() == [2.0, 0.0, 0.0, 0.0]
    gout = torch.ones(4, device=cuda_device)
    grad = mo.global_moments_backward(const, out, gout)
    assert torch.isfinite(grad).all()
    # a contiguous view that starts 4 bytes into an allocation: no 16-byte loads
    base = torch.randn(1001, device=cuda_device)
    view = base[1:].view(10, 100)
    torch.testing.assert_close(mo.global_moments_packed(view),
                               torch.stack(mo.global_moments_reference(view)),
                               rtol=1e-4, atol=1e-6)
    out = mo.global_moments_packed(view)
    torch.testing.assert_close(mo.global_moments_backward(view, out, gout),
                               mo.global_moments_backward_reference(view, out, gout),
                               rtol=1e-4, atol=1e-7)


def test_moments_kernel_rejects_bad_inputs(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo

    z = torch.randn(8, 16, device=cuda_device)
    for bad, error in ((z.double(), TypeError), (z.half(), TypeError), (z[0], ValueError),
                       (z.t(), ValueError), (z[:0], ValueError)):
        with pytest.raises(error):
            mo.global_moments(bad)
    out = mo.global_moments_packed(z)
    with pytest.raises(ValueError):
        mo.global_moments_backward(z, out.cpu(), torch.ones(4, device=cuda_device))
    with pytest.raises(ValueError):
        mo.global_moments_backward(z, out, torch.ones(3, device=cuda_device))


def _counts(mo):
    return (mo.launches, mo.bwd_launches, mo.perdim_launches, mo.perdim_bwd_launches)


PERDIM_CASES = [((256, 2000), "float32"), ((768, 2000), "float32"), ((37, 53), "float32"),
                ((1, 53), "float32"), ((256, 2000), "bfloat16"), ((37, 53), "bfloat16"),
                ((1, 64), "bfloat16")]


@pytest.mark.parametrize("shape, dtype", PERDIM_CASES,
                         ids=[f"{s[0]}x{s[1]}-{d}" for s, d in PERDIM_CASES])
def test_perdim_kernel_matches_plain_version(cuda_device, shape, dtype):
    """Forward and backward, column by column; rtol 1e-5 on mean and
    variance, 1e-4 on skew, kurtosis and the gradient (the order of the sums
    differs), with an absolute floor where a value is a small difference of
    large sums."""
    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    z = (torch.randn(shape, device=cuda_device, generator=gen) * 1.3 + 0.4).to(
        getattr(torch, dtype))
    gout = torch.randn((4, shape[1]), device=cuda_device, generator=gen)
    before = _counts(mo)
    out = mo.perdim_moments_packed(z)
    ref = torch.stack(mo.perdim_moments_reference(z))
    assert out.shape == (4, shape[1]) and out.dtype == torch.float32
    torch.testing.assert_close(out[:2], ref[:2], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[2:], ref[2:], rtol=1e-4, atol=1e-6)
    assert torch.equal(out, mo.perdim_moments_packed(z))  # the same bits from run to run
    grad = mo.perdim_moments_backward(z, out, gout)
    grad_ref = mo.perdim_moments_backward_reference(z, out, gout)
    scale = float(grad_ref.float().abs().max())
    torch.testing.assert_close(grad.float(), grad_ref.float(), rtol=1e-4, atol=1e-6 * scale)
    assert grad.dtype == z.dtype and bool(torch.isfinite(grad.float()).all())
    assert torch.equal(grad, mo.perdim_moments_backward(z, out, gout))
    assert _counts(mo) == (before[0], before[1], before[2] + 2, before[3] + 2)
    if shape[0] == 1:  # a single row: var 0, so skew = kurt = 0
        assert float(out[1:].abs().max()) == 0.0
    # through autograd: one forward and one backward launch, no plain version
    za = z.clone().requires_grad_(True)
    (mo.PerdimMoments.apply(za) * gout).sum().backward()
    assert _counts(mo) == (before[0], before[1], before[2] + 3, before[3] + 3)
    # bfloat16 gradients are rounded to 8 bits
    rtol = 1e-4 if dtype == "float32" else 2.0 ** -7
    torch.testing.assert_close(za.grad.float(), grad_ref.float(), rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perdim_kernel_constant_column_and_unaligned_views(cuda_device, dtype):
    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo

    dt = getattr(torch, dtype)
    z = torch.randn(64, 40, device=cuda_device).to(dt)
    z[:, 5] = 2.0  # exact in both types: the column's variance is exactly 0
    out = mo.perdim_moments_packed(z)
    assert out[:, 5].tolist() == [2.0, 0.0, 0.0, 0.0]
    # the variance row unused, as KurtosisSingle uses the rows
    za = z.clone().requires_grad_(True)
    m, _var, skew, kurt = mo.perdim_moments(za)
    (((kurt - 1.8) ** 2).mean() + (skew ** 2).mean() + torch.sqrt((m ** 2).sum())).backward()
    assert bool(torch.isfinite(za.grad.float()).all())
    # contiguous views that start one element into an allocation (4 bytes in
    # float32, 2 in bfloat16), with an even and an odd number of columns
    for rows, cols in ((10, 100), (37, 53)):
        view = torch.randn(rows * cols + 1, device=cuda_device).to(dt)[1:].view(rows, cols)
        out = mo.perdim_moments_packed(view)
        torch.testing.assert_close(out, torch.stack(mo.perdim_moments_reference(view)),
                                   rtol=1e-4, atol=1e-6)
        gout = torch.ones(4, cols, device=cuda_device)
        grad_ref = mo.perdim_moments_backward_reference(view, out, gout)
        torch.testing.assert_close(mo.perdim_moments_backward(view, out, gout).float(),
                                   grad_ref.float(), rtol=1e-4,
                                   atol=1e-6 * float(grad_ref.float().abs().max()))


def test_perdim_kernel_rejects_bad_inputs(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo

    z = torch.randn(8, 16, device=cuda_device)
    for bad, error in ((z.double(), TypeError), (z.half(), TypeError), (z[0], ValueError),
                       (z.t(), ValueError), (z[:0], ValueError)):
        with pytest.raises(error):
            mo.perdim_moments(bad)
    out = mo.perdim_moments_packed(z)
    with pytest.raises(ValueError):
        mo.perdim_moments_backward(z, out.cpu(), torch.ones(4, 16, device=cuda_device))
    with pytest.raises(ValueError):
        mo.perdim_moments_backward(z, out, torch.ones(4, 8, device=cuda_device))


@pytest.mark.parametrize("model_type, expected", [("KurtosisSingle", (0, 0, 3, 2)),
                                                  ("KLGaussian", (0, 0, 0, 0))])
def test_training_step_on_the_card_launches_its_types_kernels(cuda_device, model_type, expected):
    """A KurtosisSingle step launches the per-dimension kernels and not the
    global ones; KLGaussian launches neither; a continual-learning step (the
    weighted loss is plain PyTorch) launches none."""
    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine
    from trustedai_cl_vae_ad_tpu_torch.testing import run_train_steps, train_inputs

    config = {
        "data": {"image_size": [32, 48, 3]},
        "loss": {"kurtosis": 1.8, "w_kl_divergence": 1e-3, "w_kurtosis": 1e-2, "w_mse": 1.0,
                 "w_skew": 5e-3, "w_z_l1_reg": 1e-3},
        "model": {"type": model_type, "latent_dimensions": 8, "layers": [4, 8],
                  "decoder_dense_filters": 4},
        "training": {"batch_size": 8, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1},
    }
    model = load_model_from_config(config, seed=0)
    assert model.device.type == "cuda"
    model.compile()
    before = _counts(mo)
    outs = run_train_steps(model, train_inputs(config, n_steps=2, batch=8))
    model.test_step(train_inputs(config, n_steps=1, batch=8)[0][0])
    assert tuple(b - a for a, b in zip(before, _counts(mo))) == expected
    assert all(np.isfinite(o["loss"]) for o in outs)
    engine = StreamingEngine(model, config, inference_period_ms=0.0,
                             continuous_learning_period_ms=0.0)
    engine.enable_cont_learning = True
    before = _counts(mo)
    result = engine.process_frame(np.zeros((32, 48, 3), np.uint8) + 90, now=1.0)
    assert result.cl_stepped and np.isfinite(result.loss["loss"])
    assert _counts(mo) == before


def test_training_step_on_the_card_launches_the_moments_kernels(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.testing import run_train_steps, train_inputs

    config = {
        "data": {"image_size": [32, 48, 3]},
        "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-2, "w_mse": 1.0,
                 "w_skew": 0.0, "w_z_l1_reg": 0.0},
        "model": {"type": "KurtosisGlobal", "latent_dimensions": 8, "layers": [4, 8],
                  "decoder_dense_filters": 4},
        "training": {"batch_size": 8, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1},
    }
    model = load_model_from_config(config, seed=0)
    assert model.device.type == "cuda"
    model.compile()
    before = (mo.launches, mo.bwd_launches)
    outs = run_train_steps(model, train_inputs(config, n_steps=2, batch=8))
    model.test_step(train_inputs(config, n_steps=1, batch=8)[0][0])
    assert (mo.launches, mo.bwd_launches) == (before[0] + 3, before[1] + 2)
    assert all(np.isfinite(o["loss"]) for o in outs)
