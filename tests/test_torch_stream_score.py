"""The port's plain stream scorer vs the JAX package's reference and its
Pallas kernel (interpret mode), on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as tss
from trustedai_cl_vae_ad_tpu_torch.testing import (
    STARTS,
    compare_sequences,
    run_sequence,
    score_sequence,
)

ALPHA = 0.99


def _torch_step(state, img, rec, alpha):
    state, norm, score, count = tss.stream_score_step(
        state, torch.from_numpy(img), torch.from_numpy(rec), alpha)
    return (state, state.maps.numpy(), state.scalars.numpy(), norm.numpy(),
            float(score), float(count))


def _jax_step(fn):
    def step(state, img, rec, alpha):
        state, norm, score, count = fn(state, jnp.asarray(img), jnp.asarray(rec), alpha)
        return (state, np.asarray(state.maps), np.asarray(state.scalars), np.asarray(norm),
                float(score), float(count))
    return step


@pytest.fixture
def pallas_interpret():
    from trustedai_cl_vae_ad_tpu.ops import stream_score as jss

    old = jss._INTERPRET
    jss._INTERPRET = True
    try:
        yield jss.stream_score_step
    finally:
        jss._INTERPRET = old


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("hwc", [(12, 16, 3), (37, 53, 3)], ids=["12x16", "37x53"])
def test_plain_scorer_matches_jax_reference_and_pallas(hwc, start, pallas_interpret):
    from trustedai_cl_vae_ad_tpu.ops import stream_score as jss

    h, w, c = hwc
    imgs, recs, maps0, scalars0 = score_sequence(h, w, c, n_frames=8, seed=h, start=start)
    t_state = tss.StreamScoreState(torch.from_numpy(maps0), torch.from_numpy(scalars0))
    j_state = jss.StreamScoreState(jnp.asarray(maps0), jnp.asarray(scalars0))
    got = run_sequence(_torch_step, t_state, imgs, recs, ALPHA)
    ref = run_sequence(_jax_step(jss.stream_score_step_reference), j_state, imgs, recs, ALPHA)
    compare_sequences(got, ref, "vs jnp reference")
    pallas = run_sequence(_jax_step(pallas_interpret), j_state, imgs, recs, ALPHA)
    compare_sequences(got, pallas, "vs Pallas interpret")
    if start == "constant":
        # frame 0: err == 0 everywhere -> denom 0 and z std 0 -> count 0, NaN score
        maps, scalars, norm, score, count = got[0]
        assert count == 0.0 and np.isnan(score)
        assert np.all(norm == 0.0)
    if start == "converged":
        # the anomaly block lifts the count, and scores are finite
        counts = [o[4] for o in got]
        assert counts[-2] > max(counts[:-2])
        assert all(np.isfinite(o[3]) for o in got)


def test_state_layout_and_device_dispatch():
    state = tss.init_state(5, 7, "cpu")
    assert state.maps.shape == (2, 5, 7) and state.scalars.shape == (6,)
    assert state.maps.dtype == torch.float32
    img = torch.rand(5, 7, 3)
    before = tss.launches
    new, norm, score, count = tss.stream_score_step(state, img, img * 0.5, 0.9)
    assert tss.launches == before  # the CPU path runs the plain version, never the kernel
    assert float(new.scalars[4]) == 1.0 and norm.shape == (5, 7)
    with pytest.raises(ValueError, match="cuda and cpu"):
        tss.stream_score_step(state, img.to("meta"), img.to("meta"), 0.9)
