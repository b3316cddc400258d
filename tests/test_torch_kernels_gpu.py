"""The CUDA kernels (stream scorer, single and batched; global and per-dimension
moments; the int8 GEMM) vs their plain PyTorch versions on the card.

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


# -- the int8 GEMM ------------------------------------------------------------------------

def _rand_i8(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-127, 128, shape, device=dev, generator=gen,
                         dtype=torch.int32).to(torch.int8)


INT8_CASES = [(1, 2000, 1344, 0, None), (16, 2000, 1344, 0, None), (3, 1003, 37, 0, None),
              (3, 1003, 37, 5, 900), (5, 4096, 50, 16, 4000), (40, 512, 33, 0, None),
              (2, 131072, 17, 0, None), (16, 140000, 24, 131072, 140000), (7, 15, 1, 0, None)]


@pytest.mark.parametrize("m, k, n, k0, k1", INT8_CASES,
                         ids=[f"{m}x{k}x{n}-{k0}-{k1}" for m, k, n, k0, k1 in INT8_CASES])
def test_int8_gemm_kernel_equals_plain_version(cuda_device, m, k, n, k0, k1):
    """Bit for bit: integer sums have one right answer, whatever the order of
    the K splits' atomics. Every M tile size, aligned and ragged sizes,
    ranges that start and end off a 16-byte boundary."""
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig

    x, w = _rand_i8((m, k), 1, cuda_device), _rand_i8((n, k), 2, cuda_device)
    before = ig.launches
    got = ig.int8_gemm(x, w, k0, k1)
    assert ig.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, ig.int8_gemm_reference(x, w, k0, k1))
    assert torch.equal(got, ig.int8_gemm(x, w, k0, k1))  # the same bits from run to run
    end = k if k1 is None else k1
    want = x[:, k0:end].cpu().long() @ w[:, k0:end].cpu().long().t()
    assert torch.equal(got.cpu().long(), want)


def test_int8_gemm_kernel_saturated_wrapping_and_misaligned(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig

    k = 1 << 17
    pos = torch.full((2, k), 127, dtype=torch.int8, device=cuda_device)
    assert int(ig.int8_gemm(pos, pos)[0, 0]) == 127 * 127 * k
    assert int(ig.int8_gemm(pos, -pos)[1, 1]) == -127 * 127 * k
    # a range that leaves int32 wraps modulo 2^32, as the plain version does
    long = torch.full((1, ig.I32_EXACT_K + 8), 127, dtype=torch.int8, device=cuda_device)
    got = ig.int8_gemm(long, long)
    assert int(got[0, 0]) == 127 * 127 * (ig.I32_EXACT_K + 8) - 2 ** 32
    assert torch.equal(got, ig.int8_gemm_reference(long, long))
    # contiguous views that start one byte into an allocation: no 16-byte loads
    xv = _rand_i8((16 * 2000 + 1,), 3, cuda_device)[1:].view(16, 2000)
    wv = _rand_i8((100 * 2000 + 1,), 4, cuda_device)[1:].view(100, 2000)
    assert xv.data_ptr() % 16 and wv.data_ptr() % 16
    assert torch.equal(ig.int8_gemm(xv, wv), ig.int8_gemm_reference(xv, wv))


def test_int8_gemm_kernel_rejects_bad_inputs(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig

    x, w = _rand_i8((4, 64), 1, cuda_device), _rand_i8((6, 64), 2, cuda_device)
    for bad_x, bad_w, error in ((x.int(), w, TypeError), (x, w.float(), TypeError),
                                (x[:, ::2], w[:, ::2], ValueError), (x[0], w, ValueError),
                                (x, w[:, :32].contiguous(), ValueError),
                                (x, w.cpu(), ValueError), (x.cpu(), w, ValueError)):
        with pytest.raises(error):
            ig.int8_gemm(bad_x, bad_w)
    for k0, k1 in ((8, 8), (0, 65), (-1, 4)):
        with pytest.raises(ValueError):
            ig.int8_gemm(x, w, k0, k1)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_call_quantized_on_the_card_matches_cpu(cuda_device, mode):
    """The quantized forward of a tiny model on the card against the same
    tree on the CPU (the plain int8 product): w8a8 launches the kernel once
    per chunk of each quantized Dense, w8 never."""
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig
    from trustedai_cl_vae_ad_tpu_torch.ops import quant
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    config = {
        "data": {"image_size": [32, 48, 3]},
        "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-2, "w_mse": 1.0,
                 "w_skew": 0.0, "w_z_l1_reg": 0.0},
        "model": {"type": "KurtosisGlobal", "latent_dimensions": 8, "layers": [4, 8],
                  "decoder_dense_filters": 4},
        "training": {"batch_size": 8, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1},
    }
    cpu_model = load_model_from_config(config, seed=0, device="cpu")
    gpu_model = load_model_from_config(config, seed=0)
    gpu_model.core.load_state_dict(cpu_model.core.state_dict())
    x = torch.rand((5, 32, 48, 3), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want = quant.call_quantized(cpu_model.core, quant.quantize_params(
            cpu_model.core, cpu_model.params, min_elems=0), x, mode=mode)
        qp = quant.quantize_params(gpu_model.core, gpu_model.params, min_elems=0)
        before = ig.launches
        got = quant.call_quantized(gpu_model.core, qp, x.to(cuda_device), mode=mode)
    assert ig.launches - before == (2 if mode == "w8a8" else 0)
    # a convolution that differs by 1e-7 can flip one activation's rounding
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 if mode == "w8" else 2e-4)


# -- the batched scorer -----------------------------------------------------------------------

@pytest.mark.parametrize("hwc", [(224, 300, 3), (37, 53, 3)], ids=["224x300", "37x53"])
def test_batched_kernel_matches_plain_batched_version(cuda_device, hwc):
    """K frames in ONE launch with a validity mask, stream by stream at the
    tolerances of testing.py; a dropped frame keeps its state bit for bit and
    reports NaN and 0."""
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    h, w, c = hwc
    k, n_ticks = 5, 6
    seqs = [score_sequence(h, w, c, n_ticks, seed=10 + i, start=STARTS[i % 3]) for i in range(k)]
    valid = np.ones((n_ticks, k), bool)
    valid[0, 1] = valid[2, 3] = valid[3, 3] = False
    valid[:, 4] = False

    def run(fn):
        maps = torch.from_numpy(np.stack([s[2] for s in seqs])).to(cuda_device)
        scalars = torch.from_numpy(np.stack([s[3] for s in seqs])).to(cuda_device)
        outs = []
        for t in range(n_ticks):
            img = torch.from_numpy(np.stack([s[0][t] for s in seqs])).to(cuda_device)
            rec = torch.from_numpy(np.stack([s[1][t] for s in seqs])).to(cuda_device)
            prev = (maps, scalars)
            maps, scalars, norm, sc = fn(maps, scalars, img, rec, 0.99,
                                         torch.from_numpy(valid[t]).to(cuda_device))
            for i in np.flatnonzero(~valid[t]):
                assert torch.equal(maps[i], prev[0][i]) and torch.equal(scalars[i], prev[1][i])
                assert bool(torch.isnan(sc[i, 0])) and float(sc[i, 1]) == 0.0
            outs.append((maps.cpu().numpy(), scalars.cpu().numpy(), norm.cpu().numpy(),
                         sc.cpu().numpy()))
        return outs

    before = ss.launches
    got = run(ss.stream_score_step_batched)
    assert ss.launches == before + n_ticks
    ref = run(ss.stream_score_step_batched_reference)
    for i in range(k):
        def stream(outs):
            return [(o[0][i], o[1][i], o[2][i], float(o[3][i, 0]), float(o[3][i, 1]))
                    for o in outs]
        compare_sequences(stream(got), stream(ref), f"{h}x{w}x{c} stream {i}")


def test_batched_kernel_rejects_bad_inputs(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    k = 3
    maps = torch.zeros((k, 2, 8, 8), device=cuda_device)
    scalars = torch.zeros((k, 6), device=cuda_device)
    img = torch.rand((k, 8, 8, 3), device=cuda_device)
    ok = torch.ones(k, dtype=torch.bool, device=cuda_device)
    ss.stream_score_step_batched(maps, scalars, img, img, 0.9, ok)
    for bad in (lambda: ss.stream_score_step_batched(maps, scalars, img, img, 0.9, ok[:2]),
                lambda: ss.stream_score_step_batched(maps, scalars, img, img, 0.9, ok.float()),
                lambda: ss.stream_score_step_batched(maps, scalars, img, img, 0.9, ok.cpu()),
                lambda: ss.stream_score_step_batched(maps[:2], scalars, img, img, 0.9, ok),
                lambda: ss.stream_score_step_batched(maps, scalars[:, :5], img, img, 0.9, ok),
                lambda: ss.stream_score_step_batched(maps, scalars, img[0], img[0], 0.9, ok)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        ss.stream_score_step_batched(maps, scalars, img.double(), img.double(), 0.9, ok)


def test_multicam_tick_on_the_card_launches_each_kernel_once_per_dense_and_tick(cuda_device):
    """A w8a8 multi-camera tick launches the scorer once for all streams and
    the int8 GEMM once per chunk of each quantized Dense."""
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig
    from trustedai_cl_vae_ad_tpu_torch.ops import quant
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine

    config = {
        "data": {"image_size": [32, 48, 3]},
        "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-2, "w_mse": 1.0,
                 "w_skew": 0.0, "w_z_l1_reg": 0.0},
        "model": {"type": "KurtosisGlobal", "latent_dimensions": 8, "layers": [4, 8],
                  "decoder_dense_filters": 4},
        "training": {"batch_size": 8, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1},
    }
    model = load_model_from_config(config, seed=0)
    qp = quant.quantize_params(model.core, model.params, min_elems=0)
    engine = MultiCameraEngine(model, config, n_streams=4, qparams=qp)
    rng = np.random.RandomState(0)
    before = (ig.launches, ss.launches)
    for t in range(3):
        frames = [rng.randint(0, 255, (40, 64, 3), np.uint8) for _ in range(4)]
        frames[2] = None if t == 1 else frames[2]
        out = engine.process_frames(frames, now=float(t))
        assert (out[2] is None) == (t == 1)
        assert all(np.isfinite(r.pixel_count) for r in out if r is not None)
    assert (ig.launches - before[0], ss.launches - before[1]) == (3 * 2, 3)
