"""The CUDA kernels (stream scorer, single and batched, on one block and on one
thread-block cluster a frame; global and per-dimension
moments; the int8 GEMM on CUDA cores and on the tensor cores; the six dense-update kernels; the convolution weight
gradient on CUDA cores and on the tensor cores) vs their plain PyTorch versions
on the card, and the background checkpoint saver's copy through pinned memory.

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
    shifted,
    steps_apart,
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


# -- the int8 GEMM on the tensor cores (csrc/int8_gemm_mma.cu) ----------------------------

def _on_the_tensor_cores(ig, fn, launches=1):
    """fn's result, after checking that it launched ``launches`` times, all on "mma"."""
    before = (ig.launches, dict(ig.int8_gemm_arrangements))
    out = fn()
    torch.cuda.synchronize()
    assert ig.launches == before[0] + launches
    assert ig.int8_gemm_arrangements == dict(before[1], mma=before[1]["mma"] + launches)
    return out


# (M, K, N, chunk): the path's four shapes (N cut for time) in chunks of 131072, the probe's
# (N cut), ragged M, N edges, K tails of 16 (K = 2000 ends half way through a k32 step), M past
# one tile of 32, a last chunk of 16 bytes, several splits a chunk
MMA_CASES = [(16, 268800, 512, 131072), (1, 268800, 384, 131072), (16, 2000, 4096, 131072),
             (1, 2000, 4096, 131072), (32, 268800, 256, None), (3, 4096, 1000, None),
             (17, 2000, 130, None), (40, 1024, 200, None), (16, 144, 129, None),
             (8, 4112, 1, 2048), (5, 16384, 40, 4096)]


@pytest.mark.parametrize("m, k, n, chunk", MMA_CASES,
                         ids=[f"{m}x{k}x{n}-{c}" for m, k, n, c in MMA_CASES])
def test_mma_int8_gemm_equals_plain_version(cuda_device, m, k, n, chunk):
    """Bit for bit, in one launch however many chunks, and the same bits twice."""
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig

    x, w = _rand_i8((m, k), m + k, cuda_device), _rand_i8((n, k), n, cuda_device)
    assert ig.int8_gemm_arrangement(x, w, 0, k, chunk) == "mma"
    if chunk is None:
        def run():
            return ig.int8_gemm(x, w)
        want = ig.int8_gemm_reference(x, w)
    else:
        def run():
            return ig.int8_gemm_chunked(x, w, chunk)
        want = ig.int8_gemm_chunked_reference(x, w, chunk)
    got = _on_the_tensor_cores(ig, run)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(_on_the_tensor_cores(ig, run), got)


# (M, K, N, chunk, m, k, n): a 1 at x[m, k] and w[n, k] puts out's only nonzero at
# (k // chunk, m, n): tile corners, the last row of an N edge, the last split and the last
# chunk of the encoder Dense's shape, the second z tile of M
MMA_ONE_HOT = [(16, 2000, 300, 2000, 0, 0, 0), (16, 2000, 300, 2000, 15, 1999, 299),
               (32, 4096, 256, 4096, 31, 4095, 255), (1, 268800, 4000, 131072, 0, 268799, 3999),
               (16, 268800, 4000, 131072, 15, 131071, 127),
               (16, 268800, 4000, 131072, 9, 262143, 3968), (3, 16384, 40, 4096, 2, 4095, 17),
               (40, 512, 129, 512, 39, 511, 128)]


@pytest.mark.parametrize("m, k, n, chunk, mi, ki, ni", MMA_ONE_HOT,
                         ids=["x".join(map(str, c)) for c in MMA_ONE_HOT])
def test_mma_int8_gemm_puts_a_one_hot_product_in_its_place(cuda_device, m, k, n, chunk, mi, ki,
                                                          ni):
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig

    x = torch.zeros((m, k), dtype=torch.int8, device=cuda_device)
    w = torch.zeros((n, k), dtype=torch.int8, device=cuda_device)
    x[mi, ki], w[ni, ki] = 1, 1
    got = _on_the_tensor_cores(ig, lambda: ig.int8_gemm_chunked(x, w, chunk))
    assert got.nonzero().tolist() == [[ki // chunk, mi, ni]] and int(got[ki // chunk, mi, ni]) == 1


def test_mma_int8_gemm_saturated_chunks_and_wrapping(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig

    k = 1 << 17
    pos = torch.full((2, 2 * k), 127, dtype=torch.int8, device=cuda_device)
    got = _on_the_tensor_cores(ig, lambda: ig.int8_gemm_chunked(pos, pos, k))
    assert bool((got == 127 * 127 * k).all()) and got.shape == (2, 2, 2)
    got = _on_the_tensor_cores(ig, lambda: ig.int8_gemm_chunked(pos, -pos, k))
    assert bool((got == -127 * 127 * k).all())
    # a range that leaves int32 wraps modulo 2^32, as the plain version does
    long = torch.full((1, ig.I32_EXACT_K + 8), 127, dtype=torch.int8, device=cuda_device)
    got = _on_the_tensor_cores(ig, lambda: ig.int8_gemm(long, long))
    assert int(got[0, 0]) == 127 * 127 * (ig.I32_EXACT_K + 8) - 2 ** 32
    assert torch.equal(got, ig.int8_gemm_reference(long, long))


def test_int8_gemm_chunked_call_on_mma_equals_per_chunk_calls(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig

    x, w = _rand_i8((16, 268800), 5, cuda_device), _rand_i8((256, 268800), 6, cuda_device)
    chunked = _on_the_tensor_cores(ig, lambda: ig.int8_gemm_chunked(x, w, 131072))
    singles = [_on_the_tensor_cores(ig, lambda: ig.int8_gemm(x, w, s, min(s + 131072, 268800)))
               for s in range(0, 268800, 131072)]
    assert chunked.shape == (3, 16, 256) and torch.equal(chunked, torch.stack(singles))


def test_a_quantized_dense_of_three_chunks_is_one_launch(cuda_device):
    """ops/quant.py's encoder-Dense product: K = 268800 in 3 chunks, one launch."""
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig
    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    x, w = _rand_i8((16, 268800), 7, cuda_device), _rand_i8((300, 268800), 8, cuda_device)
    partials = _on_the_tensor_cores(ig, lambda: quant._int8_partials(x, w))
    assert len(partials) == 3
    for part, s in zip(partials, range(0, 268800, quant._I32_SAFE_K)):
        assert torch.equal(part, ig.int8_gemm_reference(x, w, s, min(s + quant._I32_SAFE_K, 268800)))


@pytest.mark.parametrize("case", ["view_at_plus_1", "k_not_a_multiple_of_16", "range_off_16",
                                  "chunk_off_16"])
def test_int8_gemm_off_the_rule_takes_the_cuda_core_kernel(cuda_device, case):
    """Counted under "cuda_core", one launch a chunk, and equal to the plain version."""
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig

    k, k0, k1, chunk = 2000, 0, 2000, 1000
    x, w = _rand_i8((16, k), 1, cuda_device), _rand_i8((100, k), 2, cuda_device)
    if case == "view_at_plus_1":
        x = _rand_i8((16 * k + 1,), 3, cuda_device)[1:].view(16, k)
    elif case == "k_not_a_multiple_of_16":
        k1 = k = 1003
        x, w = x[:, :k].contiguous(), w[:, :k].contiguous()
        chunk = 500
    elif case == "range_off_16":
        k0, k1 = 5, 1995
        chunk = k1 - k0
    else:
        chunk = 100
    assert ig.int8_gemm_arrangement(x, w, k0, k1, chunk) == "cuda_core"
    before = (ig.launches, dict(ig.int8_gemm_arrangements))
    if case == "range_off_16":
        got, want, n_launches = ig.int8_gemm(x, w, k0, k1), ig.int8_gemm_reference(x, w, k0, k1), 1
    else:
        got = ig.int8_gemm_chunked(x, w, chunk)
        want, n_launches = ig.int8_gemm_chunked_reference(x, w, chunk), -(-k // chunk)
    assert ig.launches == before[0] + n_launches
    assert ig.int8_gemm_arrangements == dict(
        before[1], cuda_core=before[1]["cuda_core"] + n_launches)
    assert torch.equal(got, want)


def test_the_int8_mma_launcher_refuses_what_the_rule_excludes(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig

    x = _rand_i8((16 * 2000 + 1,), 3, cuda_device)[1:].view(16, 2000)
    w = _rand_i8((100, 2000), 4, cuda_device)
    with pytest.raises(RuntimeError, match="mma"):
        ig._launch("mma", x, w, 0, 2000, 2000)
    with pytest.raises(RuntimeError, match="mma"):
        ig._launch("mma", w[:16], w, 0, 2000, 1000)


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
        before = (ig.launches, dict(ig.int8_gemm_arrangements))
        got = quant.call_quantized(gpu_model.core, qp, x.to(cuda_device), mode=mode)
    assert ig.launches - before[0] == (2 if mode == "w8a8" else 0)
    # the encoder Dense (K = 768) on the tensor cores, the decoder's (K = 8) on CUDA cores
    each = 1 if mode == "w8a8" else 0
    assert ig.int8_gemm_arrangements == {"mma": before[1]["mma"] + each,
                                         "cuda_core": before[1]["cuda_core"] + each}
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
    arrangements = dict(ig.int8_gemm_arrangements)
    for t in range(3):
        frames = [rng.randint(0, 255, (40, 64, 3), np.uint8) for _ in range(4)]
        frames[2] = None if t == 1 else frames[2]
        out = engine.process_frames(frames, now=float(t))
        assert (out[2] is None) == (t == 1)
        assert all(np.isfinite(r.pixel_count) for r in out if r is not None)
    assert (ig.launches - before[0], ss.launches - before[1]) == (3 * 2, 3)
    # a tick: the encoder Dense (K = 768) on the tensor cores, the decoder's (K = 8) on CUDA cores
    assert ig.int8_gemm_arrangements == {"mma": arrangements["mma"] + 3,
                                         "cuda_core": arrangements["cuda_core"] + 3}


# -- the scorer on one thread-block cluster a frame (csrc/stream_score_cluster.cu) -------------

def _forced_step(arrangement, clusters, dev):
    """A scorer step through the named arrangement (uncounted), on numpy inputs."""
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    def fn(state, img, rec, alpha):
        maps, scalars, norm, sc = ss._launch(arrangement, clusters, (), img, rec, state.maps,
                                             state.scalars, alpha, None)
        return ss.StreamScoreState(maps, scalars), norm, sc[0], sc[1]
    return _step(fn, dev)


def _cluster_sequence(dev, hwc, start, clusters, n_frames=8, seed=None):
    """(got, ref): the cluster kernel at ``clusters`` and the plain version over one sequence."""
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    h, w, c = hwc
    imgs, recs, maps0, scalars0 = score_sequence(h, w, c, n_frames, seed=h if seed is None else seed,
                                                 start=start)

    def state0():
        return ss.StreamScoreState(torch.from_numpy(maps0).to(dev), torch.from_numpy(scalars0).to(dev))

    got = run_sequence(_forced_step("cluster", clusters, dev), state0(), imgs, recs, 0.99)
    ref = run_sequence(_step(ss.stream_score_step_reference, dev), state0(), imgs, recs, 0.99)
    return got, ref


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("hwc", [(224, 300, 3), (37, 53, 3)], ids=["224x300", "37x53"])
@pytest.mark.parametrize("clusters", [8, 16], ids=["C8", "C16"])
def test_cluster_kernel_matches_plain_version(cuda_device, clusters, hwc, start):
    """Both cluster sizes, all three starts, at the tolerances of testing.py."""
    got, ref = _cluster_sequence(cuda_device, hwc, start, clusters)
    compare_sequences(got, ref, f"C={clusters} {hwc} {start}")
    if start == "constant":
        assert got[0][4] == 0.0 and np.isnan(got[0][3])


def test_the_flagship_frame_takes_the_cluster_kernel_once_a_frame(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    rule = ss.stream_score_arrangement(1, 224 * 300, 3)
    assert rule[0] == "cluster"
    state = ss.init_state(224, 300, cuda_device)
    img = torch.rand(224, 300, 3, device=cuda_device)
    before = (ss.launches, dict(ss.stream_score_arrangements))
    for _ in range(3):
        state, *_ = ss.stream_score_step(state, img, img * 0.5, 0.99)
    assert ss.launches == before[0] + 3
    assert ss.stream_score_arrangements == {"cluster": before[1]["cluster"] + 3,
                                            "block": before[1]["block"]}
    assert ss.cluster_occupancy(224 * 300, rule[1]) > 0


# (H, W, C): H*W not a multiple of 8 or 16, frames smaller than C * 32 pixels (some ranks own
# no pixel), one and four channels (the scalar loads of the HWC image)
CLUSTER_RAGGED = [(13, 17, 3), (5, 7, 3), (1, 3, 3), (16, 16, 1), (9, 11, 4), (37, 53, 1)]


@pytest.mark.parametrize("hwc", CLUSTER_RAGGED, ids=["x".join(map(str, s)) for s in CLUSTER_RAGGED])
@pytest.mark.parametrize("clusters", [8, 16], ids=["C8", "C16"])
def test_cluster_kernel_on_ragged_and_tiny_frames(cuda_device, clusters, hwc):
    for start in STARTS:
        got, ref = _cluster_sequence(cuda_device, hwc, start, clusters, n_frames=6)
        compare_sequences(got, ref, f"C={clusters} {hwc} {start}")


@pytest.mark.parametrize("clusters", [8, 16], ids=["C8", "C16"])
def test_cluster_kernel_propagates_a_nan_pixel_as_the_plain_version(cuda_device, clusters):
    """A NaN in one pixel makes err's min and max NaN, and with them the EMA min / max and the
    whole norm map; the pixel's EMAs turn NaN, and z's mean with them, so the count is 0."""
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    h, w, c = 37, 53, 3
    imgs, recs, maps0, scalars0 = score_sequence(h, w, c, 3, seed=5, start="converged")
    imgs[1, 20, 30, 1] = np.nan

    def state0():
        return ss.StreamScoreState(torch.from_numpy(maps0).to(cuda_device),
                                   torch.from_numpy(scalars0).to(cuda_device))

    got = run_sequence(_forced_step("cluster", clusters, cuda_device), state0(), imgs, recs, 0.99)
    ref = run_sequence(_step(ss.stream_score_step_reference, cuda_device), state0(), imgs, recs,
                       0.99)
    maps, scalars, norm, score, count = got[1]
    assert np.isnan(scalars[0]) and np.isnan(scalars[1])
    assert np.isnan(maps).sum() == 2 and np.isnan(maps[:, 20, 30]).all()
    for g, r in zip(got[1], ref[1]):
        np.testing.assert_array_equal(np.isnan(np.asarray(g)), np.isnan(np.asarray(r)))
    assert count == ref[1][4] == 0.0
    np.testing.assert_allclose(score, ref[1][3], rtol=1e-4)
    compare_sequences(got[:1], ref[:1], "before the NaN")


@pytest.mark.parametrize("k", [1, 16, 33], ids=["K1", "K16", "K33"])
def test_cluster_kernel_batched_with_a_validity_mask(cuda_device, k):
    """K frames in one launch (33 clusters of 16 are more than one wave), with the mask
    pattern of test_batched_kernel_matches_plain_batched_version; a dropped frame keeps its
    state bit for bit and reports NaN and 0."""
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    h, w, c = 224, 300, 3
    n_ticks = 4
    seqs = [score_sequence(h, w, c, n_ticks, seed=10 + i, start=STARTS[i % 3]) for i in range(k)]
    valid = np.ones((n_ticks, k), bool)
    valid[0, 1 % k] = valid[2, 3 % k] = valid[3, 3 % k] = False
    valid[:, 4 % k] = False if k > 4 else valid[:, 4 % k]

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

    assert ss.stream_score_arrangement(k, h * w, c)[0] == "cluster"
    before = (ss.launches, ss.stream_score_arrangements["cluster"])
    got = run(ss.stream_score_step_batched)
    assert (ss.launches, ss.stream_score_arrangements["cluster"]) == (before[0] + n_ticks,
                                                                      before[1] + n_ticks)
    ref = run(ss.stream_score_step_batched_reference)
    for i in range(k):
        def stream(outs):
            return [(o[0][i], o[1][i], o[2][i], float(o[3][i, 0]), float(o[3][i, 1]))
                    for o in outs]
        compare_sequences(stream(got), stream(ref), f"K={k} stream {i}")


@pytest.mark.parametrize("clusters", [8, 16], ids=["C8", "C16"])
def test_two_cluster_runs_give_equal_bits(cuda_device, clusters):
    got, _ = _cluster_sequence(cuda_device, (224, 300, 3), "converged", clusters)
    again, _ = _cluster_sequence(cuda_device, (224, 300, 3), "converged", clusters)
    for a, b in zip(got, again):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_a_frame_the_rule_sends_to_block_takes_it(cuda_device):
    """A 1080p frame's slice (518 KB at C = 16) does not fit a CTA: the one-block kernel."""
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    h, w, c = 1080, 1920, 3
    assert ss.stream_score_arrangement(1, h * w, c) == ("block", 1)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    img = torch.rand((h, w, c), device=cuda_device, generator=gen)
    rec = torch.rand((h, w, c), device=cuda_device, generator=gen)
    state = ss.StreamScoreState(torch.full((2, h, w), 0.3, device=cuda_device),
                                torch.tensor([0.0, 1.0, 1.0, 2.0, 1.0, 0.0], device=cuda_device))
    before = (ss.launches, dict(ss.stream_score_arrangements))
    got = ss.stream_score_step(state, img, rec, 0.99)
    assert ss.launches == before[0] + 1
    assert ss.stream_score_arrangements == {"cluster": before[1]["cluster"],
                                            "block": before[1]["block"] + 1}
    ref = ss.stream_score_step_reference(state, img, rec, 0.99)
    torch.testing.assert_close(got[0].maps, ref[0].maps, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-6)
    assert abs(float(got[3]) - float(ref[3])) <= 2


@pytest.mark.parametrize("clusters, hwc", [(32, (37, 53, 3)), (8, (1080, 1920, 3))],
                         ids=["cluster-of-32", "slice-past-shared-memory"])
def test_a_cluster_launch_the_card_refuses_raises(cuda_device, clusters, hwc):
    """A cluster larger than Hopper's (and the kernel's) 16, or a slice larger than a CTA's
    shared memory, is refused: RuntimeError naming the error, no result, and the next launch
    is unaffected."""
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    h, w, c = hwc
    img = torch.rand((h, w, c), device=cuda_device)
    state = ss.init_state(h, w, cuda_device)
    before = (ss.launches, dict(ss.stream_score_arrangements))
    with pytest.raises(RuntimeError, match="stream_score \\(cluster\\)"):
        ss._launch("cluster", clusters, (), img, img, state.maps, state.scalars, 0.99, None)
    assert (ss.launches, ss.stream_score_arrangements) == before
    small = torch.rand((37, 53, 3), device=cuda_device)
    out = ss.stream_score_step(ss.init_state(37, 53, cuda_device), small, small * 0.5, 0.99)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out[0].maps).all())


# -- the dense-update kernels (csrc/dense_grad_adam.cu) ---------------------------------

DGA_SHAPES = [((5, 37, 53), "bfloat16"), ((5, 37, 53), "float32"), ((3, 1003, 250), "bfloat16"),
              ((3, 1003, 250), "float32"), ((64, 384, 256), "bfloat16"),
              ((64, 384, 256), "float32"), ((768, 12800, 4000), "bfloat16"),
              ((768, 12800, 4096), "bfloat16"), ((768, 2000, 13440), "bfloat16")]
DGA_IDS = [f"{'x'.join(map(str, s))}-{d}" for s, d in DGA_SHAPES]
DGA_NAMES = ("w", "mu", "nu")


def _dga_case(dev, shape, dtype, offset=0):
    """Operands with the probes' scales; with ``offset`` every tensor starts
    that many elements into its allocation (off a 16-byte boundary)."""
    from trustedai_cl_vae_ad_tpu_torch.probes import r11

    K, M, N = shape
    gen = torch.Generator(device=dev).manual_seed(K + M + N)
    ops = r11.make_operands(K, M, N, dev, gen, dtype=getattr(torch, dtype))
    ops["g"] = r11.make_gradient(M, N, dev, gen, getattr(torch, dtype))
    ops["xt"] = ops["x"].t().contiguous()
    if offset:
        ops = {k: shifted(v, offset) for k, v in ops.items()}
    return ops


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "plus_one_element"])
@pytest.mark.parametrize("shape, dtype", DGA_SHAPES[:6], ids=DGA_IDS[:6])
def test_stream_copy_kernel_copies_bit_for_bit(cuda_device, shape, dtype, offset):
    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga

    ops = _dga_case(cuda_device, shape, dtype, offset)
    src = [ops[k] for k in DGA_NAMES]
    before = dga.launches["stream_copy"]
    new = dga.stream_copy(*src)
    given = dga.stream_copy(*src, out=[shifted(torch.zeros_like(t), offset) for t in src])
    own = [t.clone() for t in src]
    dga.stream_copy(*own, out=own)
    torch.cuda.synchronize()
    assert dga.launches["stream_copy"] == before + 3
    for outs in (new, given, own):
        assert all(torch.equal(a, b) for a, b in zip(outs, src))


DGA_EPILOGUES = [(s, d, a) for s, d in DGA_SHAPES
                 for a in ("float32", "bfloat16")[:1 + (d == "bfloat16")]]


@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("shape, dtype, arithmetic", DGA_EPILOGUES,
                         ids=[f"{'x'.join(map(str, s))}-{d}-{a}_arithmetic"
                              for s, d, a in DGA_EPILOGUES])
def test_streaming_epilogue_kernels_equal_their_plain_versions(cuda_device, shape, dtype,
                                                               arithmetic, count):
    """Bit for bit: the same operations in the same order, each rounded once
    (``--fmad=false``, IEEE division and root)."""
    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga
    from trustedai_cl_vae_ad_tpu_torch.probes.r11 import ADAM

    for offset in (0, 1):
        ops = _dga_case(cuda_device, shape, dtype, offset)
        got = [shifted(ops[k], offset) for k in DGA_NAMES]
        ref = [ops[k].clone() for k in DGA_NAMES]
        key = "epilogue_bf16" if arithmetic == "bfloat16" else "epilogue_f32"
        before = dga.launches[key]
        dga.adam_epilogue_step(ops["g"], *got, count=count, arithmetic=arithmetic, **ADAM)
        assert dga.launches[key] == before + 1
        reference = (dga.adam_epilogue_bf16_reference if arithmetic == "bfloat16"
                     else dga.adam_epilogue_reference)
        reference(ops["g"], *ref, count=count, **ADAM)
        torch.cuda.synchronize()
        for name, a, b in zip(DGA_NAMES, got, ref):
            assert torch.equal(a, b), (name, offset, steps_apart(a, b))
        assert not torch.equal(got[0], ops["w"])


@pytest.mark.parametrize("shape, dtype", DGA_SHAPES, ids=DGA_IDS)
def test_dense_grad_kernel_matches_a_float64_product(cuda_device, shape, dtype):
    """bfloat16: within one step of the float64 product rounded once (the
    float32 sum is far finer than its rounding); float32: within K steps
    (each of the K additions rounds once)."""
    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga

    ops = _dga_case(cuda_device, shape, dtype)
    before = dga.launches["dense_grad"]
    got = dga.dense_grad(ops["x"], ops["dz"])
    again = dga.dense_grad(ops["x"], ops["dz"], out=torch.empty_like(got))
    torch.cuda.synchronize()
    assert dga.launches["dense_grad"] == before + 2 and torch.equal(got, again)
    g64 = ops["x"].double().t() @ ops["dz"].double()
    # where the K products cancel, the float32 sum carries up to K roundings at the size
    # of its partial sums, which a small result's own step does not cover
    _share, worst = steps_apart(got, g64.float().to(got.dtype),
                                     floor=shape[0] * 2.0 ** -24 * float(g64.abs().max()))
    assert worst <= (1.0 if dtype == "bfloat16" else shape[0])


# -- the tensor-core arrangement of the product (csrc/dense_grad_wgmma.cu) -----------------------

# (K, M, N, k, i, j): a 1 at x[k, i] and at dz[k, j] puts g's only nonzero at (i, j). Corners
# of a tile, a row of the second warpgroup (i % 128 >= 64), the last stage of K (its tail),
# the masked N edge (N = 200: the second tile of N holds 72 columns), a second tile of M and
# of N, every k % 8 and 16-byte chunk c % 8 of the swizzle somewhere
DGW_ONE_HOT = [(200, 256, 200, 0, 0, 0), (200, 256, 200, 5, 64, 8), (200, 256, 200, 199, 127, 199),
               (200, 256, 200, 130, 200, 131), (200, 256, 200, 71, 71, 9),
               (200, 256, 200, 66, 250, 192), (200, 256, 200, 127, 129, 63),
               (3, 64, 128, 2, 63, 127), (64, 384, 256, 63, 383, 255), (64, 384, 256, 17, 300, 100)]
DGW_SHAPES = [(3, 64, 128), (64, 384, 256), (200, 1000, 4000), (768, 12800, 4000)]


@pytest.mark.parametrize("K, M, N, k, i, j", DGW_ONE_HOT,
                         ids=[f"{K}x{M}x{N}-k{k}-i{i}-j{j}" for K, M, N, k, i, j in DGW_ONE_HOT])
def test_wgmma_dense_grad_puts_a_one_hot_product_in_its_place(cuda_device, K, M, N, k, i, j):
    """A wrong swizzle, descriptor or fragment map moves or loses the single 1."""
    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga

    x = torch.zeros((K, M), dtype=torch.bfloat16, device=cuda_device)
    dz = torch.zeros((K, N), dtype=torch.bfloat16, device=cuda_device)
    x[k, i] = 1.0
    dz[k, j] = 1.0
    before = dga.dense_grad_arrangements["wgmma"]
    g = dga.dense_grad(x, dz)
    torch.cuda.synchronize()
    assert dga.dense_grad_arrangements["wgmma"] == before + 1
    assert g.nonzero().tolist() == [[i, j]] and float(g[i, j]) == 1.0


@pytest.mark.parametrize("shape", [(3, 64, 128), (70, 136, 72), (200, 1000, 4000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wgmma_dense_grad_is_exact_on_small_integers(cuda_device, shape):
    """Integers in [-3, 3]: every partial sum is an integer below 2^11, exact in
    any order, so every element equals the float64 product: the whole tile map
    is checked bit for bit."""
    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga

    K, M, N = shape
    gen = torch.Generator(device=cuda_device).manual_seed(K + M + N)
    x = torch.randint(-3, 4, (K, M), generator=gen, device=cuda_device).to(torch.bfloat16)
    dz = torch.randint(-3, 4, (K, N), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = dga.dense_grad_arrangements["wgmma"]
    got = dga.dense_grad(x, dz)
    torch.cuda.synchronize()
    assert dga.dense_grad_arrangements["wgmma"] == before + 1
    assert torch.equal(got, (x.double().t() @ dz.double()).to(torch.bfloat16))


@pytest.mark.parametrize("shape", DGW_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wgmma_dense_grad_matches_a_float64_product(cuda_device, shape):
    """Within one bfloat16 step of the float64 product rounded once, on at most
    1% of the elements, with the floor K 2^-24 max|g| where the terms cancel;
    two runs give equal bits; both launches counted under "wgmma"."""
    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga

    ops = _dga_case(cuda_device, shape, "bfloat16")
    before = dict(dga.dense_grad_arrangements)
    got = dga.dense_grad(ops["x"], ops["dz"])
    again = dga.dense_grad(ops["x"], ops["dz"], out=torch.empty_like(got))
    torch.cuda.synchronize()
    assert dga.dense_grad_arrangements == {"wgmma": before["wgmma"] + 2,
                                           "cuda_core": before["cuda_core"]}
    assert torch.equal(got, again)
    g64 = ops["x"].double().t() @ ops["dz"].double()
    share, worst = steps_apart(got, g64.float().to(torch.bfloat16),
                               floor=shape[0] * 2.0 ** -24 * float(g64.abs().max()))
    assert worst <= 1.0 and share <= 0.01, (share, worst)


# (shape, dtype, offset of x and dz, offset of out): float32, ragged M or N, views that do
# not start on a 16-byte boundary
DGW_CUDA_CORE = [((5, 37, 53), "bfloat16", 0, 0), ((3, 1003, 250), "bfloat16", 0, 0),
                 ((64, 384, 256), "float32", 0, 0), ((64, 384, 256), "bfloat16", 1, 0),
                 ((64, 384, 256), "bfloat16", 0, 1)]


@pytest.mark.parametrize("shape, dtype, offset, out_offset", DGW_CUDA_CORE,
                         ids=[f"{'x'.join(map(str, s))}-{d}-{o}-{p}"
                              for s, d, o, p in DGW_CUDA_CORE])
def test_dense_grad_keeps_the_cuda_core_arrangement_off_the_rule(cuda_device, shape, dtype, offset,
                                                                 out_offset):
    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga

    ops = _dga_case(cuda_device, shape, dtype, offset)
    out = shifted(torch.empty((shape[1], shape[2]), dtype=ops["x"].dtype, device=cuda_device),
                  out_offset)
    assert dga.dense_grad_arrangement(ops["x"], ops["dz"], out) == "cuda_core"
    before = dict(dga.dense_grad_arrangements)
    dga.dense_grad(ops["x"], ops["dz"], out=out)
    torch.cuda.synchronize()
    assert dga.dense_grad_arrangements == {"wgmma": before["wgmma"],
                                           "cuda_core": before["cuda_core"] + 1}
    g64 = ops["x"].double().t() @ ops["dz"].double()
    _share, worst = steps_apart(out, g64.float().to(out.dtype),
                                floor=shape[0] * 2.0 ** -24 * float(g64.abs().max()))
    assert worst <= (1.0 if dtype == "bfloat16" else shape[0])


@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("tile", ["default", "big"])
@pytest.mark.parametrize("x_transposed", [False, True], ids=["x_km", "x_mk"])
@pytest.mark.parametrize("shape, dtype", DGA_SHAPES, ids=DGA_IDS)
def test_fused_kernels_match_their_plain_version(cuda_device, shape, dtype, x_transposed, tile,
                                                 count):
    """The K sums are taken in another order than the plain product's, which
    now and then flips the rounding of g: w, mu, nu within one bfloat16 step
    on at most 1% of the elements (float32: K steps, anywhere), and within
    1/64 of the tensor's scale, as the archived harness asks. In place, and
    two runs give equal bits."""
    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga
    from trustedai_cl_vae_ad_tpu_torch.probes.r11 import ADAM

    offset = int(shape == (3, 1003, 250))
    ops = _dga_case(cuda_device, shape, dtype, offset)
    x = ops["xt"] if x_transposed else ops["x"]
    got = [shifted(ops[k], offset) for k in DGA_NAMES]
    again = [ops[k].clone() for k in DGA_NAMES]
    ref = [ops[k].clone() for k in DGA_NAMES]
    key = "fused_xt" if x_transposed else "fused"
    before = dga.launches[key]
    out = dga.fused_dense_grad_adam(x, ops["dz"], *got, count=count, x_transposed=x_transposed,
                                    tile=tile, **ADAM)
    dga.fused_dense_grad_adam(x, ops["dz"], *again, count=count, x_transposed=x_transposed,
                              tile=tile, **ADAM)
    assert dga.launches[key] == before + 2 and all(a is b for a, b in zip(out, got))
    dga.fused_dense_grad_adam_reference(ops["x"], ops["dz"], *ref, count=count, **ADAM)
    torch.cuda.synchronize()
    # where its terms cancel, a sum is held to a step at the size of the terms
    terms = [torch.maximum(ops["w"].float().abs(), (ops["w"].float() - ref[0].float()).abs()),
             torch.maximum(ops["mu"].float().abs(),
                           dga.dense_grad_reference(ops["x"], ops["dz"]).float().abs()), None]
    max_steps, max_share = (1.0, 0.01) if dtype == "bfloat16" else (float(shape[0]), 1.0)
    for i, name in enumerate(DGA_NAMES):
        assert torch.equal(got[i], again[i]), f"two runs differ in {name}"
        share, worst = steps_apart(got[i], ref[i], terms[i])
        scale = float((got[i].float() - ref[i].float()).abs().max() / ref[i].float().abs().max())
        assert worst <= max_steps and share <= max_share and scale < 1 / 64, \
            (name, share, worst, scale)
    assert not torch.equal(got[0], ops["w"])


def test_dense_update_kernels_reject_bad_inputs(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga
    from trustedai_cl_vae_ad_tpu_torch.probes.r11 import ADAM

    ops = _dga_case(cuda_device, (4, 8, 6), "bfloat16")
    x, dz, w, mu, nu, g = (ops[k] for k in ("x", "dz", "w", "mu", "nu", "g"))
    before = dict(dga.launches)
    with pytest.raises(TypeError):
        dga.dense_grad(x.double(), dz.double())
    with pytest.raises(TypeError):
        dga.fused_dense_grad_adam(x, dz, w, mu.float(), nu, count=1, **ADAM)
    with pytest.raises(TypeError):
        dga.adam_epilogue_step(g.float(), w.float(), mu.float(), nu.float(), count=1,
                               arithmetic="bfloat16", **ADAM)
    with pytest.raises(ValueError):
        dga.fused_dense_grad_adam(ops["xt"].t(), dz, w, mu, nu, count=1, **ADAM)
    with pytest.raises(ValueError):
        dga.adam_epilogue_step(g, w, w, nu, count=1, **ADAM)
    with pytest.raises(ValueError):
        dga.fused_dense_grad_adam(x, dz.cpu(), w, mu, nu, count=1, **ADAM)
    with pytest.raises(ValueError):
        dga.fused_dense_grad_adam(x, dz, w.t().contiguous(), mu, nu, count=1, **ADAM)
    with pytest.raises(ValueError):
        dga.stream_copy(w, mu, nu, out=(mu, w, nu))
    assert dga.launches == before


# -- the convolution weight gradient (csrc/conv_dw.cu) ------------------------------------------

# (B, H, W, CI, CO): the archived check's shapes, a ragged batch, CI = 1, one run of a line
# longer than a staging step, more channels than one tile, the flagship's two layers at batch 2
CONV_DW_CASES = [(2, 8, 12, 3, 8), (3, 16, 16, 5, 4), (5, 6, 10, 3, 32), (2, 6, 8, 1, 4),
                 (1, 4, 150, 32, 64), (3, 4, 70, 40, 70), (2, 224, 300, 3, 32),
                 (2, 112, 150, 32, 64)]


def _conv_dw_operands(shape, dtype, dev, offset=0):
    b, h, w, ci, co = shape
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn((b, h, w, ci), device=dev, generator=gen).to(dtype)
    dy = torch.randn((b, h // 2, w // 2, co), device=dev, generator=gen).to(dtype)
    return (shifted(x, offset), shifted(dy, offset)) if offset else (x, dy)


def _conv_dw_float64(x, dy):
    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw

    return cdw.conv_dw_reference(x, dy, accumulate=torch.float64)


def _assert_near_float64(got, ref64):
    """Within 1e-4 of the largest |dW| plus 1e-4 relative of the float64 reference."""
    err = (got.double() - ref64).abs()
    scale = float(ref64.abs().max())
    assert bool((err <= 1e-4 * scale + 1e-4 * ref64.abs()).all()), (float(err.max()), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CONV_DW_CASES, ids=[str(s) for s in CONV_DW_CASES])
def test_conv_dw_kernel_matches_plain_version(cuda_device, shape, dtype):
    """Against the plain version (float32 products by the library): the sums are taken
    in another order, so 1e-4 of the largest |dW| plus 1e-4 relative. The same values
    one element into an allocation: equal bits where both calls take one arrangement
    (the CUDA-core kernel's staging reads element by element in the same order); where
    the aligned call took the tensor cores, the view takes the CUDA-core kernel, and
    each is held to the float64 reference instead."""
    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw

    x, dy = _conv_dw_operands(shape, dtype, cuda_device)
    arrangement = cdw.conv_dw_arrangement(x, dy)
    before = (cdw.launches, dict(cdw.conv_dw_arrangements))
    got = cdw.conv_dw(x, dy)
    torch.cuda.synchronize()
    assert cdw.launches == before[0] + 1
    assert cdw.conv_dw_arrangements[arrangement] == before[1][arrangement] + 1
    ref = cdw.conv_dw_reference(x, dy)
    assert got.shape == ref.shape == (3, 3, shape[3], shape[4]) and got.dtype == torch.float32
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(got, cdw.conv_dw(x, dy)), "two runs differ"
    xs, dys = _conv_dw_operands(shape, dtype, cuda_device, offset=1)
    assert xs.data_ptr() % 16 and cdw.conv_dw_arrangement(xs, dys) == "cuda_core"
    shifted_dw = cdw.conv_dw(xs, dys)
    if arrangement == "cuda_core":
        assert torch.equal(got, shifted_dw)
    else:
        ref64 = _conv_dw_float64(x, dy)
        _assert_near_float64(got, ref64)
        _assert_near_float64(shifted_dw, ref64)


# -- the tensor-core arrangement of the weight gradient (csrc/conv_dw_wgmma.cu) -------------------

# ((B, H, W, CI, CO), x index, dy index): a single 1 in each puts dW's only nonzero at
# (h - 2 oh, w - 2 ow, ci, co) when that tap exists. Tile corners; the second and third
# warpgroups (kh = 1, 2); the right padding column (w = W - 1 at ow = OW - 1: kw = 1 only; the
# kw = 2 tap of it is padding); the bottom row; a second tile of CI and of CO; a position in
# the last stage of a split (the last position of all); a tap that does not exist
CONV_DW_ONE_HOT = [
    ((1, 4, 150, 32, 64), (0, 0, 0, 0), (0, 0, 0, 0)),
    ((1, 4, 150, 32, 64), (0, 3, 149, 31), (0, 1, 74, 63)),
    ((1, 4, 150, 32, 64), (0, 2, 148, 17), (0, 1, 74, 40)),
    ((1, 4, 150, 32, 64), (0, 1, 10, 8), (0, 0, 5, 1)),
    ((2, 8, 140, 40, 72), (1, 7, 139, 39), (1, 3, 69, 71)),
    ((2, 8, 140, 40, 72), (1, 6, 130, 33), (1, 2, 64, 70)),
    ((2, 112, 150, 32, 64), (1, 111, 149, 31), (1, 55, 74, 63)),
    ((2, 112, 150, 32, 64), (0, 57, 64, 9), (0, 28, 32, 5)),
    ((3, 6, 10, 8, 8), (2, 5, 9, 7), (2, 2, 4, 7)),
    ((1, 4, 150, 32, 64), (0, 0, 0, 0), (0, 1, 0, 0)),
]
# (B, H, W, CI, CO): one line; the flagship's conv2 at batch 2; a K tail (P = 7 x 5 x 3 = 105
# positions, no multiple of 64); a ragged OW (67) whose lines cross the 64-position stages; a
# second, partial tile of CI (40); CO = 8; two tiles of CO (128)
CONV_DW_WGMMA = [(1, 4, 150, 32, 64), (2, 112, 150, 32, 64), (7, 10, 6, 16, 24),
                 (3, 6, 134, 32, 64), (3, 4, 70, 40, 64), (5, 6, 130, 64, 8),
                 (2, 4, 140, 32, 128)]


def _counted(cdw, arrangement, fn):
    """fn() launched once, under ``arrangement``."""
    before = (cdw.launches, dict(cdw.conv_dw_arrangements))
    out = fn()
    torch.cuda.synchronize()
    want = dict(before[1], **{arrangement: before[1][arrangement] + 1})
    assert (cdw.launches, cdw.conv_dw_arrangements) == (before[0] + 1, want)
    return out


@pytest.mark.parametrize("shape, xi, di", CONV_DW_ONE_HOT,
                         ids=[f"{'x'.join(map(str, s))}-x{'.'.join(map(str, a))}-dy"
                              f"{'.'.join(map(str, d))}" for s, a, d in CONV_DW_ONE_HOT])
def test_wgmma_conv_dw_puts_a_one_hot_product_in_its_place(cuda_device, shape, xi, di):
    """A wrong swizzle, descriptor, gather offset, padding mask or fragment map moves
    or loses the single 1."""
    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw

    b, h, w, ci, co = shape
    x = torch.zeros((b, h, w, ci), dtype=torch.bfloat16, device=cuda_device)
    dy = torch.zeros((b, h // 2, w // 2, co), dtype=torch.bfloat16, device=cuda_device)
    x[xi] = 1.0
    dy[di] = 1.0
    got = _counted(cdw, "wgmma", lambda: cdw.conv_dw(x, dy))
    kh, kw = xi[1] - 2 * di[1], xi[2] - 2 * di[2]
    want = [[kh, kw, xi[3], di[3]]] if xi[0] == di[0] and 0 <= kh < 3 and 0 <= kw < 3 else []
    assert got.nonzero().tolist() == want
    assert all(float(got[tuple(i)]) == 1.0 for i in want)


@pytest.mark.parametrize("shape", CONV_DW_WGMMA, ids=[str(s) for s in CONV_DW_WGMMA])
def test_wgmma_conv_dw_matches_a_float64_reference(cuda_device, shape):
    """Within 1e-4 of the largest |dW| plus 1e-4 relative of the float64 sums
    (products of bfloat16 values are exact; float32 sums in another order); two
    runs give equal bits; both launches counted under "wgmma"."""
    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw

    x, dy = _conv_dw_operands(shape, torch.bfloat16, cuda_device)
    got = _counted(cdw, "wgmma", lambda: cdw.conv_dw(x, dy))
    assert got.shape == (3, 3, shape[3], shape[4]) and got.dtype == torch.float32
    _assert_near_float64(got, _conv_dw_float64(x, dy))
    assert torch.equal(got, _counted(cdw, "wgmma", lambda: cdw.conv_dw(x, dy)))


def test_wgmma_conv_dw_is_exact_on_small_integers(cuda_device):
    """Integers in [-2, 2]: every partial sum is an integer below 2^24, exact in any
    order, so the whole result equals the float64 sums bit for bit."""
    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw

    b, h, w, ci, co = 3, 6, 134, 40, 72
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randint(-2, 3, (b, h, w, ci), generator=gen, device=cuda_device).bfloat16()
    dy = torch.randint(-2, 3, (b, h // 2, w // 2, co), generator=gen,
                       device=cuda_device).bfloat16()
    got = _counted(cdw, "wgmma", lambda: cdw.conv_dw(x, dy))
    assert torch.equal(got.double(), _conv_dw_float64(x, dy))


# bfloat16 operands off the rule, and float32: the CUDA-core kernel with its checks
CONV_DW_CUDA_CORE = [((2, 8, 12, 3, 8), torch.bfloat16, 0),
                     ((3, 4, 70, 40, 70), torch.bfloat16, 0),
                     ((2, 6, 8, 12, 16), torch.bfloat16, 0),
                     ((1, 4, 150, 32, 64), torch.float32, 0),
                     ((1, 4, 150, 32, 64), torch.bfloat16, 1)]


@pytest.mark.parametrize("shape, dtype, offset", CONV_DW_CUDA_CORE,
                         ids=[f"{'x'.join(map(str, s))}-{str(d)[6:]}-{o}"
                              for s, d, o in CONV_DW_CUDA_CORE])
def test_conv_dw_keeps_the_cuda_core_arrangement_off_the_rule(cuda_device, shape, dtype, offset):
    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw

    x, dy = _conv_dw_operands(shape, dtype, cuda_device, offset)
    assert cdw.conv_dw_arrangement(x, dy) == "cuda_core"
    got = _counted(cdw, "cuda_core", lambda: cdw.conv_dw(x, dy))
    _assert_near_float64(got, _conv_dw_float64(x, dy))


def test_the_wgmma_launcher_refuses_what_the_rule_excludes(cuda_device):
    """Handed operands off the rule, the tensor-core launcher raises: nothing is rerouted."""
    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw

    x, dy = _conv_dw_operands((1, 4, 150, 32, 64), torch.bfloat16, cuda_device, offset=1)
    before = (cdw.launches, dict(cdw.conv_dw_arrangements))
    with pytest.raises(RuntimeError, match="wgmma"):
        cdw._launch("wgmma", x, dy)
    x, dy = _conv_dw_operands((2, 8, 12, 12, 16), torch.bfloat16, cuda_device)
    with pytest.raises(RuntimeError, match="wgmma"):
        cdw._launch("wgmma", x, dy)
    assert (cdw.launches, cdw.conv_dw_arrangements) == before


def test_conv_dw_kernel_rejects_bad_inputs(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw

    x, dy = _conv_dw_operands((2, 8, 12, 3, 8), torch.float32, cuda_device)
    before = cdw.launches
    for bad, error in (((x[:, :7], dy), ValueError), ((x.bfloat16(), dy), TypeError),
                       ((x.double(), dy.double()), TypeError), ((x, dy.cpu()), ValueError),
                       ((x, dy[:, :3].contiguous()), ValueError),
                       ((x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), dy), ValueError)):
        with pytest.raises(error):
            cdw.conv_dw(*bad)
    assert cdw.launches == before


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)],
                         ids=["float32", "bfloat16"])
def test_conv_dw_function_matches_autograd_on_the_card(cuda_device, dtype, rtol):
    """Forward, dx and dW of ``conv2d_s2_kernel_dw`` against autograd of the
    port's ``conv2d_same`` in float32 (TF32 off)."""
    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw
    from trustedai_cl_vae_ad_tpu_torch.probes import r18
    from trustedai_cl_vae_ad_tpu_torch.registry import use_full_float32

    use_full_float32()
    shape = (4, 32, 48, 32, 64)
    x, dy = _conv_dw_operands(shape, torch.float32, cuda_device)
    weight = torch.randn((3, 3, 32, 64), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1)) * 0.1
    ref_dx, ref_dw = r18.autograd_gradients(x, weight, dy)
    xx = x.to(dtype).clone().requires_grad_(True)
    ww = weight.to(dtype).clone().requires_grad_(True)
    before = cdw.launches
    (cdw.conv2d_s2_kernel_dw(xx, ww) * dy.to(dtype)).sum().backward()
    assert cdw.launches == before + 1 and ww.grad.dtype == dtype
    for got, ref in ((xx.grad, ref_dx), (ww.grad, ref_dw)):
        torch.testing.assert_close(got.float(), ref, rtol=rtol,
                                   atol=rtol * float(ref.abs().max()))


def test_r18_check_mode_runs_the_kernel_on_the_card(cuda_device):
    from trustedai_cl_vae_ad_tpu_torch.probes import r18
    from trustedai_cl_vae_ad_tpu_torch.registry import use_full_float32

    use_full_float32()
    rows = r18.check(device=cuda_device)
    assert [r["launches"] for r in rows] == [2, 2]  # the kernel alone, then through the Function


# -- the background checkpoint saver's copy off the card ------------------------------------------

def test_async_saver_copies_through_pinned_memory_before_it_returns(cuda_device, tmp_path):
    """Tensors larger than the pinned buffers, of a size that is no multiple
    of them, mutated in place right after ``save`` returns: the round holds
    the values at ``save``."""
    from trustedai_cl_vae_ad_tpu_torch.train import checkpoint

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = {"encoder.w": torch.randn((1031, 1021), device=cuda_device, generator=gen),
              "encoder.b": torch.randn((7,), device=cuda_device, generator=gen),
              "decoder.w": torch.randn((513, 2050), device=cuda_device,
                                       generator=gen).to(torch.bfloat16)}
    opt = {"count": 3, "mu": {k: v * 2 for k, v in params.items()},
           "nu": {k: v * 3 for k, v in params.items()}}
    want = {k: v.clone() for k, v in params.items()}
    saver = checkpoint.AsyncSaver(pinned_bytes=1 << 20)
    d = str(tmp_path / "log")
    saver.save(d, params, opt_state=opt)
    for t in (*params.values(), *opt["mu"].values(), *opt["nu"].values()):
        t.mul_(-1.0)  # the training step that follows, in place
    saver.close()
    restored = checkpoint.restore_params(d, map_location=cuda_device)
    state = checkpoint.restore_optimizer_state(d, map_location=cuda_device)
    for k, v in want.items():
        assert torch.equal(restored[k], v) and restored[k].dtype == v.dtype, k
        assert torch.equal(state["mu"][k], v * 2) and torch.equal(state["nu"][k], v * 3), k
    assert state["count"] == 3
