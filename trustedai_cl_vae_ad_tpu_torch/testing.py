"""Scorer parity fixtures and checks shared by the tests and ``chip_smoke.py``.

One place states the inputs and the tolerances with which an implementation
of the stream-scorer update (the CUDA kernel, the plain PyTorch version, the
JAX package's functions) is held against a reference:

  * maps, scalars and the norm map: rtol 1e-5, atol 1e-6. The per-pixel
    steps round identically; only the frame-wide sums (mean and std of z)
    are taken in another order.
  * count: within 2. ``zz > 3`` is a hard threshold, and a rounding-level
    change of the z mean or std flips pixels that sit on it.
  * score: rtol 1e-4, and NaN exactly where the reference is NaN, on every
    frame up to the first one whose counts differ (the count EMAs carry
    every earlier count into the score). On a fresh state's first frame
    err - EMA(err) is 0 or one rounding step, so z there is rounding noise:
    two implementations that round one product differently can count 0 and
    1 pixels, and score NaN (0/0) and the cap sqrt(alpha/(1 - alpha)).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

MAP_RTOL, MAP_ATOL = 1e-5, 1e-6
COUNT_TOL = 2
SCORE_RTOL = 1e-4

# one scorer update on numpy inputs: (state, img, rec, alpha) ->
# (state, maps, scalars, norm, score, count) with the last five as numpy
StepFn = Callable[[object, np.ndarray, np.ndarray, float], Tuple]


STARTS = ("constant", "seeding", "converged")


def score_sequence(h: int, w: int, c: int, n_frames: int = 8, seed: int = 0,
                   start: str = "seeding"):
    """(imgs, recs, maps0, scalars0): a static scene with per-frame pixel
    noise (sigma 0.05) against a fixed reconstruction, float32 in [0, 1],
    and the scorer state to start from.

    ``start``:
      * "constant": fresh state, and frame 0 has rec == img. err is 0
        everywhere, so the min/max denominator and the z std are both 0 and
        the score is NaN (0/0).
      * "seeding": fresh state, an ordinary frame 0 that seeds the EMAs.
      * "converged": a state whose EMAs match the noise, as after a long
        stream; z is then O(1) and the anomaly block in the last-but-one
        frame (a bright square) drives it to its cap, so the count and the
        finite-score branch run. A fresh state at alpha 0.99 needs hundreds
        of frames to get there.
    """
    if start not in STARTS:
        raise ValueError(f"start must be one of {STARTS}")
    rng = np.random.RandomState(seed)
    sigma = 0.05
    scene = rng.uniform(0.2, 0.8, (h, w, c)).astype(np.float32)
    imgs = np.clip(scene + rng.normal(0, sigma, (n_frames, h, w, c)), 0, 1).astype(np.float32)
    recs = np.broadcast_to(scene, imgs.shape).copy()
    if start == "constant":
        recs[0] = imgs[0]
    if n_frames >= 3:
        k = n_frames - 2
        bh, bw = max(h // 4, 1), max(w // 4, 1)
        imgs[k, h // 2: h // 2 + bh, w // 2: w // 2 + bw] = 1.0
    maps0 = np.zeros((2, h, w), np.float32)
    scalars0 = np.zeros((6,), np.float32)
    if start == "converged":
        # err = sum of c squared N(0, sigma^2): mean c s^2, E[err^2] = (c^2 + 2c) s^4
        maps0[0] = c * sigma**2
        maps0[1] = (c * c + 2 * c) * sigma**4
        scalars0[:] = [0.0, 0.06, 20.0, 500.0, 1.0, 0.0]
    return imgs, recs, maps0, scalars0


def warm_score_state(h: int, w: int):
    """(maps, scalars) of a scorer that has seen a quiet stream (EMAs of a
    per-pixel error of about 0.1). Engines compared frame by frame start
    from it: a fresh state's first count is f32 rounding noise (see above),
    which would make their score histories differ from frame 0 on."""
    maps = np.stack([np.full((h, w), 0.1, np.float32), np.full((h, w), 0.0125, np.float32)])
    scalars = np.array([0.0, 1.0, 1.0, 2.0, 1.0, 0.0], np.float32)
    return maps, scalars


def run_sequence(step: StepFn, state, imgs: np.ndarray, recs: np.ndarray,
                 alpha: float) -> List[Tuple]:
    outs = []
    for img, rec in zip(imgs, recs):
        state, *rest = step(state, img, rec, alpha)
        outs.append(tuple(rest))
    return outs


def compare_sequences(got: Sequence[Tuple], ref: Sequence[Tuple], label: str = "") -> float:
    """Hold ``got`` against ``ref`` (outputs of ``run_sequence``) at the
    tolerances above; raises AssertionError on a violation and returns the
    largest absolute difference over the maps and the norm map."""
    max_err = 0.0
    counts_agreed = True
    for i, ((g_maps, g_scal, g_norm, g_score, g_count),
            (r_maps, r_scal, r_norm, r_score, r_count)) in enumerate(zip(got, ref)):
        where = f"{label} frame {i}"
        np.testing.assert_allclose(g_maps, r_maps, rtol=MAP_RTOL, atol=MAP_ATOL, err_msg=where)
        np.testing.assert_allclose(g_norm, r_norm, rtol=MAP_RTOL, atol=MAP_ATOL, err_msg=where)
        # [min_ema, max_ema, initialized, unused] depend on no count
        np.testing.assert_allclose(g_scal[[0, 1, 4, 5]], r_scal[[0, 1, 4, 5]],
                                   rtol=MAP_RTOL, atol=MAP_ATOL, err_msg=where)
        max_err = max(max_err, float(np.max(np.abs(g_maps - r_maps))),
                      float(np.max(np.abs(g_norm - r_norm))))
        assert abs(float(g_count) - float(r_count)) <= COUNT_TOL, (
            f"{where}: count {g_count} vs {r_count}")
        counts_agreed = counts_agreed and float(g_count) == float(r_count)
        if not counts_agreed:
            continue  # the count EMAs differ from here on, and so do the scores
        assert np.isnan(g_score) == np.isnan(r_score), (
            f"{where}: score {g_score} vs {r_score} (NaN must match)")
        if not np.isnan(r_score):
            np.testing.assert_allclose(g_scal[2:4], r_scal[2:4], rtol=MAP_RTOL,
                                       atol=MAP_ATOL, err_msg=where)
            np.testing.assert_allclose(g_score, r_score, rtol=SCORE_RTOL, err_msg=where)
    return max_err
