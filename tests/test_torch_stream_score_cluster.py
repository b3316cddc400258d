"""Kernel 1's cluster arrangement on the CPU: which kernel ``stream_score_arrangement``
picks (by shape alone), a numpy model of ``csrc/stream_score_cluster.cu``'s slice
partition and of its joins (each rank's partials folded in rank order) held against the
port's plain version and the JAX package's reference, that CPU tensors take the plain
version and count no launch, and the source's note, C interface and build.

The kernel itself runs only on the card: ``tests/test_torch_kernels_gpu.py``.
"""

import functools
import importlib
import re
import stat
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustedai_cl_vae_ad_tpu_torch.ops import _build
from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss
from trustedai_cl_vae_ad_tpu_torch.testing import (
    STARTS,
    compare_sequences,
    run_sequence,
    score_sequence,
)

REPO = Path(__file__).resolve().parents[1]
SOURCE = _build.CSRC / "stream_score_cluster.cu"
ALPHA = 0.99


def _root_module(name):
    """A script at the repo's root, imported as a module (nothing of it runs)."""
    sys.path.insert(0, str(REPO))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(REPO))


# -- the rule -------------------------------------------------------------------------------

# (H, W, C, K, arrangement): the flagship, a camera's 240x320 and 480x640, tiny frames, many
# frames in a tick, and frames whose slice does not fit a CTA's shared memory
RULE_CASES = [(224, 300, 3, 1, "cluster"), (224, 300, 3, 16, "cluster"),
              (240, 320, 3, 1, "cluster"), (240, 320, 3, 16, "cluster"),
              (480, 640, 3, 1, "cluster"), (480, 640, 3, 33, "cluster"),
              (37, 53, 3, 1, "cluster"), (5, 7, 3, 3, "cluster"), (1, 1, 1, 1, "cluster"),
              (720, 1280, 3, 1, "cluster"), (224, 300, 3, 65535, "cluster"),
              (224, 300, 3, 65536, "block"), (1080, 1920, 3, 1, "block"),
              (2160, 3840, 3, 4, "block")]


@pytest.mark.parametrize("h, w, c, k, arrangement", RULE_CASES,
                         ids=[f"{h}x{w}x{c}-K{k}" for h, w, c, k, _ in RULE_CASES])
def test_the_rule_by_shape(h, w, c, k, arrangement):
    got = ss.stream_score_arrangement(k, h * w, c)
    assert got[0] == arrangement
    if arrangement == "cluster":
        assert got[1] in ss.CLUSTER_SIZES
        assert 4 * ss.cluster_slice(h * w, got[1]) <= ss.SLICE_BUDGET_BYTES
    else:
        assert got == ("block", 1)


@pytest.mark.parametrize("k, preference", [(1, (16, 8)), (8, (16, 8)), (9, (8, 16)),
                                           (16, (8, 16)), (33, (8, 16))])
def test_clusters_of_16_while_one_cta_an_sm_holds_them_all(k, preference):
    assert ss.cluster_preference(k) == preference
    assert ss.stream_score_arrangement(k, 224 * 300, 3) == ("cluster", preference[0])
    assert 16 * 8 <= ss.SMS < 16 * 9


@pytest.mark.parametrize("k", [1, 16])
def test_the_rule_takes_the_first_preferred_size_whose_slice_fits(k):
    """The preferred size wherever its slice fits; a frame whose slice fits only at the
    other size takes it; a frame that fits at neither takes the block kernel."""
    for clusters in ss.CLUSTER_SIZES:
        hw = ss.SLICE_BUDGET_BYTES // 4 * clusters  # every rank's slice exactly at the budget
        fits = [s for s in ss.cluster_preference(k)
                if 4 * ss.cluster_slice(hw, s) <= ss.SLICE_BUDGET_BYTES]
        assert ss.stream_score_arrangement(k, hw, 3) == ("cluster", fits[0])
    too_big = (ss.SLICE_BUDGET_BYTES // 4 + ss.SLICE_GROUP) * max(ss.CLUSTER_SIZES)
    assert ss.stream_score_arrangement(k, too_big, 3) == ("block", 1)


def test_the_budget_is_a_hopper_blocks_shared_memory_less_the_scratch():
    assert ss.SLICE_BUDGET_BYTES == 232448 - 1024
    # the kernel's static scratch: 4 joins x 16 warps, 16 warps' counts, 4 joins x 16 ranks'
    # partials, 16 ranks' counts (640 bytes, as ptxas reports)
    assert (4 * 16 + 16 + 4 * 16 + 16) * 4 < 1024
    assert set(ss.CLUSTER_SIZES) <= {8, 16} and 8 in ss.CLUSTER_SIZES


@pytest.mark.parametrize("k, hw, c", [(0, 100, 3), (1, 0, 3), (1, 100, 0)])
def test_the_rule_refuses_an_empty_launch(k, hw, c):
    with pytest.raises(ValueError):
        ss.stream_score_arrangement(k, hw, c)


def test_build_for_builds_the_library_the_rule_picks(monkeypatch):
    monkeypatch.setattr(ss, "build", lambda: "block library")
    monkeypatch.setattr(ss, "build_cluster", lambda: "cluster library")
    assert ss.build_for(1, 224 * 300, 3) == "cluster library"
    assert ss.build_for(1, 1080 * 1920, 3) == "block library"


# -- the slice partition --------------------------------------------------------------------

def _slices(hw, clusters):
    """[(p0, p1)] of each rank 0..clusters-1, as the kernel computes them: rank r owns
    [min(r s, hw), min(r s + s, hw)) with s = ``ss.cluster_slice(hw, clusters)``."""
    s = ss.cluster_slice(hw, clusters)
    return [(min(r * s, hw), min(min(r * s, hw) + s, hw)) for r in range(clusters)]


PARTITION_HW = [1, 3, 4, 5, 35, 64, 127, 128, 129, 255, 1961, 67200, 76800, 307200, 921600]


@pytest.mark.parametrize("clusters", [8, 16])
@pytest.mark.parametrize("hw", PARTITION_HW)
def test_every_pixel_is_owned_by_exactly_one_rank(hw, clusters):
    slices = _slices(hw, clusters)
    assert len(slices) == clusters
    owner = np.zeros(hw, np.int64)
    for p0, p1 in slices:
        assert 0 <= p0 <= p1 <= hw
        owner[p0:p1] += 1
    assert (owner == 1).all()
    # rank r's slice starts at r * s (a multiple of 4 pixels: 16 bytes of every map and of
    # the HWC image at C = 3), and no rank owns more than s
    s = ss.cluster_slice(hw, clusters)
    assert s % ss.SLICE_GROUP == 0 and s * clusters >= hw
    for r, (p0, p1) in enumerate(slices):
        assert p0 == min(r * s, hw) and p1 - p0 <= s
        assert p1 == p0 or (p0 * 3 * 4) % 16 == 0


def test_the_flagships_slices_are_even():
    assert ss.cluster_slice(224 * 300, 16) == 4200 and ss.cluster_slice(224 * 300, 8) == 8400
    assert {p1 - p0 for p0, p1 in _slices(224 * 300, 16)} == {4200}


def test_a_frame_smaller_than_the_cluster_leaves_ranks_without_pixels():
    slices = _slices(5 * 7, 16)
    assert slices[:9] == [(4 * r, min(4 * r + 4, 35)) for r in range(9)]
    assert all(p0 == p1 == 35 for p0, p1 in slices[9:])


# -- a numpy model of the kernel's joins -----------------------------------------------------

def _min_op(a, b):  # MinOp / MaxOp of the source: NaN propagates from either side
    return a if (a != a or a < b) else b


def _max_op(a, b):
    return a if (a != a or a > b) else b


def _rank_fold(parts, op):
    """What every CTA computes: the ranks' partials folded in rank order 0..C-1."""
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc


def _cluster_model_step(maps, scalars, img, rec, alpha, clusters):
    """One update as the cluster kernel decomposes it, in float32: per-pixel steps in the
    source's order, each rank's partials over its slice (an empty slice gives the identity),
    the partials folded in rank order, the count summed as integers."""
    f32 = np.float32
    a, one = f32(alpha), f32(1.0)
    oma = one - a
    h, w, c = img.shape
    hw = h * w
    d = (img - rec).reshape(hw, c)
    err = d[:, 0] * d[:, 0]
    for ch in range(1, c):
        err = err + d[:, ch] * d[:, ch]
    slices = _slices(hw, clusters)

    def parts(values, reduce, identity):
        return [reduce(values[p0:p1]) if p1 > p0 else f32(identity) for p0, p1 in slices]

    e_min = _rank_fold(parts(err, lambda v: functools.reduce(_min_op, v), np.inf), _min_op)
    e_max = _rank_fold(parts(err, lambda v: functools.reduce(_max_op, v), -np.inf), _max_op)
    min_ema = a * scalars[0] + oma * e_min
    max_ema = a * scalars[1] + oma * e_max
    denom = max_ema - min_ema
    norm = (err - min_ema) / (one if denom == 0 else denom)
    initialized = scalars[4] > 0
    m0, m1 = maps[0].reshape(hw), maps[1].reshape(hw)
    prev = m0 if initialized else err
    prev2 = m1 if initialized else err * err
    ema = a * prev + oma * err
    ema2 = a * prev2 + (oma * err) * err
    var = np.abs(ema2 - ema * ema)
    z = (err - ema) * (one / np.sqrt(var + f32(1e-10)))

    def fsum(v):
        return np.add.reduce(v, dtype=f32)

    n = f32(hw)
    z_mean = _rank_fold(parts(z, fsum, 0.0), lambda x, y: x + y) / n
    zc = z - z_mean
    z_std = np.sqrt(_rank_fold(parts(zc * zc, fsum, 0.0), lambda x, y: x + y) / n)
    zz = zc / (one if z_std == 0 else z_std)
    count = f32(sum(int(np.count_nonzero(zz[p0:p1] > 3)) for p0, p1 in slices))
    as_sum = a * scalars[2] + oma * count
    as_sum2 = a * scalars[3] + (oma * count) * count
    with np.errstate(invalid="ignore", divide="ignore"):
        score = (count - as_sum) / np.sqrt(as_sum2 - as_sum * as_sum)
    new_maps = np.stack([ema.reshape(h, w), ema2.reshape(h, w)]).astype(f32)
    new_scalars = np.array([min_ema, max_ema, as_sum, as_sum2, 1.0, 0.0], f32)
    return new_maps, new_scalars, norm.reshape(h, w).astype(f32), float(score), float(count)


def _model(clusters):
    def step(state, img, rec, alpha):
        maps, scalars = state
        with np.errstate(invalid="ignore"):
            out = _cluster_model_step(maps, scalars, img, rec, alpha, clusters)
        return ((out[0], out[1]),) + out
    return step


def _torch_step(state, img, rec, alpha):
    state, norm, score, count = ss.stream_score_step(
        state, torch.from_numpy(img), torch.from_numpy(rec), alpha)
    return (state, state.maps.numpy(), state.scalars.numpy(), norm.numpy(), float(score),
            float(count))


def _jax_step(state, img, rec, alpha):
    from trustedai_cl_vae_ad_tpu.ops import stream_score as jss

    state, norm, score, count = jss.stream_score_step_reference(
        state, jnp.asarray(img), jnp.asarray(rec), alpha)
    return (state, np.asarray(state.maps), np.asarray(state.scalars), np.asarray(norm),
            float(score), float(count))


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("clusters", [8, 16])
def test_the_join_model_matches_the_plain_version_and_jax(clusters, start):
    """At 37x53x3 (1961 pixels: the last rank's slice is ragged, no rank's ends on a
    multiple of the frame's width) the decomposition gives the plain version's and the JAX
    reference's sequence within the tolerances of testing.py."""
    from trustedai_cl_vae_ad_tpu.ops import stream_score as jss

    h, w, c = 37, 53, 3
    imgs, recs, maps0, scalars0 = score_sequence(h, w, c, 8, seed=h, start=start)
    got = run_sequence(_model(clusters), (maps0, scalars0), imgs, recs, ALPHA)
    plain = run_sequence(_torch_step, ss.StreamScoreState(torch.from_numpy(maps0),
                                                          torch.from_numpy(scalars0)),
                         imgs, recs, ALPHA)
    jax_ref = run_sequence(_jax_step, jss.StreamScoreState(jnp.asarray(maps0),
                                                           jnp.asarray(scalars0)),
                           imgs, recs, ALPHA)
    compare_sequences(got, plain, f"C={clusters} {start} vs the plain version")
    compare_sequences(got, jax_ref, f"C={clusters} {start} vs JAX")


@pytest.mark.parametrize("clusters", [8, 16])
def test_every_rank_folds_the_same_bits(clusters):
    """Partials of mixed magnitudes whose sum depends on the order: the rank-order fold that
    every CTA makes gives one value, bit for bit, whichever rank computes it; another order
    can give another value, which is why the order is fixed."""
    rng = np.random.RandomState(clusters)
    parts = (rng.standard_normal(clusters) * 10.0 ** rng.randint(-6, 7, clusters)).astype(
        np.float32)
    folds = {_rank_fold(list(parts), lambda x, y: np.float32(x + y)).tobytes()
             for _rank in range(clusters)}
    assert len(folds) == 1
    orders = {_rank_fold(list(parts[np.random.RandomState(s).permutation(clusters)]),
                         lambda x, y: np.float32(x + y)).tobytes() for s in range(50)}
    assert len(orders) > 1


@pytest.mark.parametrize("where", [0, 5, 15])
def test_the_min_max_fold_propagates_a_nan_from_any_rank(where):
    parts = [np.float32(v) for v in np.linspace(0.5, 2.0, 16)]
    parts[where] = np.float32(np.nan)
    assert np.isnan(_rank_fold(parts, _min_op)) and np.isnan(_rank_fold(parts, _max_op))
    clean = [np.float32(v) for v in np.linspace(0.5, 2.0, 16)]
    assert _rank_fold(clean, _min_op) == 0.5 and _rank_fold(clean, _max_op) == 2.0


def test_a_nan_pixel_in_the_model_propagates_as_in_the_plain_version():
    h, w, c = 37, 53, 3
    imgs, recs, maps0, scalars0 = score_sequence(h, w, c, 3, seed=5, start="converged")
    imgs[1, 20, 30, 1] = np.nan
    got = run_sequence(_model(16), (maps0, scalars0), imgs, recs, ALPHA)
    plain = run_sequence(_torch_step, ss.StreamScoreState(torch.from_numpy(maps0),
                                                          torch.from_numpy(scalars0)),
                         imgs, recs, ALPHA)
    for g, p in zip(got[1], plain[1]):
        np.testing.assert_array_equal(np.isnan(np.asarray(g)), np.isnan(np.asarray(p)))
    assert np.isnan(got[1][1][:2]).all() and got[1][4] == plain[1][4] == 0.0


# -- CPU tensors ----------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = (ss.launches, dict(ss.stream_score_arrangements))
    state = ss.init_state(37, 53, "cpu")
    img = torch.rand(37, 53, 3)
    ss.stream_score_step(state, img, img * 0.5, 0.99)
    ss.stream_score_step_batched(torch.zeros(3, 2, 37, 53), torch.zeros(3, 6),
                                 img.expand(3, -1, -1, -1).contiguous(),
                                 img.expand(3, -1, -1, -1).contiguous() * 0.5, 0.99,
                                 torch.ones(3, dtype=torch.bool))
    assert (ss.launches, ss.stream_score_arrangements) == before
    assert set(ss.stream_score_arrangements) == {"cluster", "block"}


# -- the source -----------------------------------------------------------------------------

@pytest.mark.parametrize("needle", [
    "trustedai_cl_vae_ad_tpu/ops/stream_score.py::", "_stream_kernel", "What bounds it",
    "The design", "cg::this_cluster()", "map_shared_rank", "cluster.sync()",
    "cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension", "__launch_bounds__(kThreads, 2)",
    "cudaOccupancyMaxActiveClusters", "cudaFuncAttributeNonPortableClusterSizeAllowed",
    "cudaFuncAttributeMaxDynamicSharedMemorySize",
    'extern "C" int stream_score_cluster_launch(',
    'extern "C" int stream_score_cluster_occupancy(',
    'extern "C" const char* stream_score_cluster_error_string(',
])
def test_the_source_carries_its_note_and_c_interface(needle):
    assert needle in SOURCE.read_text()


def test_the_sources_constants_are_the_wrappers():
    text = SOURCE.read_text()
    assert re.search(r"constexpr int kGroup = (\d+);", text).group(1) == str(ss.SLICE_GROUP)
    assert re.search(r"constexpr int kPortableCluster = (\d+);", text).group(1) == "8"
    # slice_pixels: ceil(hw / cluster), rounded up to a multiple of kGroup
    body = text[text.index("inline int slice_pixels("):]
    body = body[:body.index("}")]
    assert "(hw + cluster - 1) / cluster" in body
    assert "(per_rank + kGroup - 1) / kGroup * kGroup" in body


def test_the_source_joins_four_times_and_reads_no_peer_after_a_barrier():
    """Four cluster barriers, one a join; the only remote accesses are the pushes before
    them (push() and the count), and the first push waits for the barrier every CTA
    arrives at on entry."""
    code = "\n".join(line for line in SOURCE.read_text().splitlines()
                     if not line.lstrip().startswith("//"))
    kernel = code[code.index("stream_score_cluster_kernel("):code.index("cudaLaunchConfig_t")]
    assert kernel.count("cluster.sync();") == 4
    assert kernel.count("push(cluster, sc,") == 4  # min, max, sum z, sum (z - mean)^2
    assert kernel.count("fold(sc,") == 4
    assert kernel.count("map_shared_rank") == 1  # the count, to rank 0
    assert kernel.index("cluster_arrive_relaxed();") < kernel.index("cluster_wait();") < \
        kernel.index("push(cluster, sc,")
    assert "map_shared_rank" not in kernel[kernel.rindex("cluster.sync();"):]
    assert "barrier.cluster.arrive.relaxed.aligned" in code
    assert "barrier.cluster.wait.aligned" in code


def test_the_replaced_tpu_kernel_is_where_the_note_says():
    lines = (REPO / "trustedai_cl_vae_ad_tpu" / "ops" / "stream_score.py").read_text().splitlines()
    assert lines[97].startswith("def _stream_kernel(")


def test_the_block_source_is_kept_beside_the_cluster_one():
    assert "stream_score.cu" in SOURCE.read_text()
    assert (_build.CSRC / "stream_score.cu").is_file()
    text = (_build.CSRC.parent / "ops" / "stream_score.py").read_text()
    assert "stream_score_cluster.cu" in text and "csrc/stream_score.cu" in text


def test_the_library_is_built_once_under_its_digest(tmp_path, monkeypatch):
    """A stand-in nvcc records each command line: the source is built for sm_90a once."""
    log = tmp_path / "commands.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    for name in ("_loaded", "build_log", "library_paths"):
        monkeypatch.setattr(_build, name, {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("library", path))
    first = _build.load_library("stream_score_cluster")[1]
    _build._loaded.clear()
    assert _build.load_library("stream_score_cluster")[1] == first
    digest = _build.source_digest(SOURCE, _build.NVCC_FLAGS)
    assert Path(first).name == f"stream_score_cluster-{digest}.so"
    assert _build.included_headers(SOURCE) == []
    (command,) = log.read_text().splitlines()
    assert "arch=compute_90a,code=sm_90a" in command and "--fmad=false" in command
    assert command.endswith("stream_score_cluster.cu")


# -- the bounds ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 16])
def test_row_1_of_the_bounds_is_chip_smokes(k):
    """kernel_bounds_torch.py's row 1 counts the bytes and operations chip_smoke.py does."""
    kb, smoke = _root_module("kernel_bounds_torch"), _root_module("chip_smoke")
    rows = [r for r in kb.bounds() if r["row"] == 1 and f"K={k} " in r["shapes"]]
    assert len(rows) == 1 and rows[0]["ported"]
    bound_ms, bound_by = smoke.scorer_bound(k, 224, 300, 3)
    assert rows[0]["bound_ms"] == pytest.approx(bound_ms, rel=1e-12)
    assert rows[0]["bound_by"] == bound_by == "bytes"
    assert rows[0]["bytes"] == pytest.approx(k * 2.96e6, rel=0.01)


def test_every_kernel_of_the_table_has_a_row_and_is_ported():
    kb = _root_module("kernel_bounds_torch")
    table = kb.bounds()
    assert {r["row"] for r in table} == set(range(1, 12))
    assert all(r["ported"] for r in table)
    assert kb.PORTED == set(range(1, 12))
