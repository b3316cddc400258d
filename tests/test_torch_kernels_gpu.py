"""The stream-scorer CUDA kernel vs its plain PyTorch version on the card.

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
