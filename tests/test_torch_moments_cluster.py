"""Kernels 2 and 3 on thread-block clusters, on the CPU: the arrangement
``moments_arrangement`` picks (by shape, dtype and alignment alone), a numpy model of
``csrc/moments_cluster.cu``'s slice and tile partitions and of its joins (each CTA's
partials folded in rank order) held against the port's plain versions and the JAX
package's kernels in interpret mode, that CPU tensors take the plain versions and count no
launch, and the source's note, constants, C interface and build.

The kernels themselves run only on the card: ``tests/test_torch_kernels_gpu.py``.
"""

import importlib
import re
import stat
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from trustedai_cl_vae_ad_tpu.ops import moments as jmoments
from trustedai_cl_vae_ad_tpu_torch.ops import _build
from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo

REPO = Path(__file__).resolve().parents[1]
SOURCE = _build.CSRC / "moments_cluster.cu"
F32, BF16 = torch.float32, torch.bfloat16


def _root_module(name):
    """A script at the repo's root, imported as a module (nothing of it runs)."""
    sys.path.insert(0, str(REPO))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(REPO))


def _constant(name, text=None):
    text = SOURCE.read_text() if text is None else text
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", text).group(1)


# -- the rule -------------------------------------------------------------------------------

# (kind, shape, dtype, aligned, cluster, tiles, slice, staged, vector)
RULE_CASES = [
    ("global", (256, 2000), F32, True, 16, 1, 32000, True, True),   # the flagship: 128 KB a CTA
    ("global", (256, 2000), BF16, True, 16, 1, 32000, True, True),  # 64 KB a CTA
    ("global", (768, 2000), F32, True, 16, 1, 96000, False, True),  # 384 KB: streamed
    ("global", (768, 2000), BF16, True, 16, 1, 96000, True, True),  # 192,000 bytes: fits
    ("global", (7, 13), F32, True, 16, 1, 8, True, True),
    ("global", (7, 13), BF16, True, 16, 1, 8, True, True),
    ("global", (10, 100), F32, False, 16, 1, 64, False, False),     # a view off 16 bytes
    ("global", (1, 1), F32, True, 16, 1, 4, True, True),
    ("perdim", (256, 2000), F32, True, 8, 16, 32, True, True),      # the flagship: 128 CTAs
    ("perdim", (256, 2000), BF16, True, 8, 8, 32, True, True),
    ("perdim", (768, 2000), F32, True, 8, 16, 96, True, True),
    ("perdim", (37, 53), F32, True, 8, 1, 5, True, False),          # 212-byte rows
    ("perdim", (37, 53), BF16, True, 8, 1, 5, True, False),
    ("perdim", (1, 53), F32, True, 1, 1, 1, True, False),           # a batch of one
    ("perdim", (3, 64), BF16, True, 2, 1, 2, True, True),
    ("perdim", (10, 100), F32, False, 8, 1, 2, True, False),        # a view off 16 bytes
    ("perdim", (256, 4000), F32, True, 4, 32, 64, True, True),      # 32 tiles: clusters of 4
    ("perdim", (256, 134400), F32, True, 1, 1050, 256, True, True),
    ("perdim", (100000, 2000), F32, True, 8, 16, 12500, False, True),  # 6.4 MB a CTA: streamed
]


@pytest.mark.parametrize(
    "kind, shape, dtype, aligned, cluster, tiles, slice_, staged, vector", RULE_CASES,
    ids=[f"{c[0]}-{c[1][0]}x{c[1][1]}-{str(c[2])[6:]}-{'a' if c[3] else 'u'}" for c in RULE_CASES])
def test_the_rule_by_shape(kind, shape, dtype, aligned, cluster, tiles, slice_, staged, vector):
    got = mo.moments_arrangement(kind, shape, dtype, aligned)
    assert got == mo.MomentsArrangement(kind, cluster, tiles, slice_, staged, vector)


def test_the_constants_are_hoppers():
    assert mo.STAGE_BUDGET_BYTES == 232448 - 32768
    assert mo.GLOBAL_CLUSTER == 16 and mo.MAX_PERDIM_CLUSTER == 8 and mo.SMS == 132
    assert mo.tile_columns(F32) == 128 and mo.tile_columns(BF16) == 256


@pytest.mark.parametrize("shape", [(0, 5), (5, 0), (0, 0)])
@pytest.mark.parametrize("kind", ["global", "perdim"])
def test_the_rule_refuses_an_empty_z(kind, shape):
    with pytest.raises(ValueError):
        mo.moments_arrangement(kind, shape, F32, True)


def test_the_rule_refuses_other_kinds_and_types():
    with pytest.raises(ValueError):
        mo.moments_arrangement("rows", (4, 4), F32, True)
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            mo.moments_arrangement("global", (4, 4), dtype, True)


@settings(max_examples=200, deadline=None)
@given(rows=st.integers(1, 5000), cols=st.integers(1, 5000), bf16=st.booleans(),
       aligned=st.booleans())
def test_every_arrangement_is_one_the_source_takes(rows, cols, bf16, aligned):
    """What mc_global_forward / mc_perdim_forward accept: slices of whole 16-byte vectors
    that cover z, clusters the source takes, a staged share within the budget, at most
    SMS CTAs of clusters larger than 1, nothing staged off 16 bytes (global)."""
    dtype = BF16 if bf16 else F32
    size, width = (2, 8) if bf16 else (4, 4)
    g = mo.moments_arrangement("global", (rows, cols), dtype, aligned)
    n = rows * cols
    assert g.cluster == 16 and g.tiles == 1
    assert g.slice % width == 0 and g.slice * g.cluster >= n and g.slice <= n + width
    assert g.vector == aligned and (not g.staged or aligned)
    assert g.staged == (aligned and g.slice * size <= mo.STAGE_BUDGET_BYTES)
    p = mo.moments_arrangement("perdim", (rows, cols), dtype, aligned)
    tile = mo.tile_columns(dtype)
    assert p.cluster in (1, 2, 4, 8) and tile % p.cluster == 0 and p.cluster <= rows
    assert p.tiles == -(-cols // tile) and p.slice * p.cluster >= rows and p.slice <= rows
    assert p.cluster == 1 or p.tiles * p.cluster <= mo.SMS
    assert p.staged == (p.slice * tile * size <= mo.STAGE_BUDGET_BYTES)
    assert p.vector == (aligned and (cols * size) % 16 == 0)


# -- the partitions -------------------------------------------------------------------------

def _global_slices(n, arrangement):
    """[(e0, e1)] of each rank, as the kernel computes them."""
    s = arrangement.slice
    return [(min(r * s, n), min(min(r * s, n) + s, n)) for r in range(arrangement.cluster)]


def _perdim_blocks(rows, cols, arrangement, dtype):
    """[(rank, tile, b0, b1, c0, c1)] of every CTA, as the kernel computes them."""
    tile = mo.tile_columns(dtype)
    out = []
    for t in range(arrangement.tiles):
        for r in range(arrangement.cluster):
            b0 = min(r * arrangement.slice, rows)
            out.append((r, t, b0, min(b0 + arrangement.slice, rows), t * tile,
                        min(t * tile + tile, cols)))
    return out


@settings(max_examples=150, deadline=None)
@given(rows=st.integers(1, 3000), cols=st.integers(1, 3000), bf16=st.booleans())
def test_every_element_is_owned_by_exactly_one_rank(rows, cols, bf16):
    dtype = BF16 if bf16 else F32
    n = rows * cols
    g = mo.moments_arrangement("global", (rows, cols), dtype, True)
    owner = np.zeros(n, np.int64)
    for e0, e1 in _global_slices(n, g):
        assert 0 <= e0 <= e1 <= n and e1 - e0 <= g.slice
        owner[e0:e1] += 1
        # every slice starts on a 16-byte boundary of an aligned z
        assert e0 == e1 or (e0 * (2 if bf16 else 4)) % 16 == 0
    assert (owner == 1).all()
    p = mo.moments_arrangement("perdim", (rows, cols), dtype, True)
    cells = np.zeros((rows, cols), np.int64)
    for _r, _t, b0, b1, c0, c1 in _perdim_blocks(rows, cols, p, dtype):
        cells[b0:b1, c0:c1] += 1
    assert (cells == 1).all()


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_the_flagships_slices_are_even_and_start_on_16_bytes(dtype):
    g = mo.moments_arrangement("global", (256, 2000), dtype, True)
    slices = _global_slices(512000, g)
    assert {e1 - e0 for e0, e1 in slices} == {32000}
    size = 2 if dtype == BF16 else 4
    assert all((e0 * size) % 16 == 0 for e0, _ in slices)
    assert g.slice * size in (128000, 64000)  # 128 KB f32, 64 KB bf16 of shared memory a CTA
    p = mo.moments_arrangement("perdim", (256, 2000), dtype, True)
    blocks = _perdim_blocks(256, 2000, p, dtype)
    assert len(blocks) == (128 if dtype == F32 else 64)
    assert {b1 - b0 for _r, _t, b0, b1, _c0, _c1 in blocks} == {32}
    # every tile's rows start on a 512-byte row segment: one warp's 32 lanes of 16 bytes
    assert all((c0 * size) % 512 == 0 for *_, c0, _c1 in blocks)


def test_a_z_smaller_than_the_cluster_leaves_ranks_without_elements():
    g = mo.moments_arrangement("global", (7, 13), F32, True)
    slices = _global_slices(91, g)
    assert slices[:12] == [(8 * r, min(8 * r + 8, 91)) for r in range(12)]
    assert all(e0 == e1 == 91 for e0, e1 in slices[12:])


def _thread_vectors(nv, threads, chunks, staged):
    """The vectors each thread of a global-forward CTA adds in pass 1, in order: chunk by
    chunk when staged, one stride over the slice when streamed (the source's loops)."""
    per_chunk = -(-(-(-nv // chunks)) // threads) * threads
    if not staged:
        return [list(range(t, nv, threads)) for t in range(threads)]
    out = [[] for _ in range(threads)]
    for c in range(chunks):
        v0 = min(c * per_chunk, nv)
        v1 = min(v0 + per_chunk, nv)
        for t in range(threads):
            out[t].extend(range(v0 + t, v1, threads))
    return out


@pytest.mark.parametrize("nv", [1, 7, 1000, 1023, 1024, 1025, 8000, 8193, 24000])
def test_staged_and_streamed_threads_add_the_same_vectors_in_the_same_order(nv):
    """A chunk holds a multiple of the CTA's threads in vectors, so a thread's vectors do
    not depend on the chunks: staged and streamed give the same bits."""
    threads, chunks = int(_constant("kGlobalThreads")), int(_constant("kChunks"))
    assert _thread_vectors(nv, threads, chunks, True) == \
        _thread_vectors(nv, threads, chunks, False)


# -- a numpy model of the joins ---------------------------------------------------------------

def _seq_sum(values):
    """float32 sum in order, as one thread accumulates."""
    acc = np.float32(0.0)
    for v in np.asarray(values, np.float32):
        acc = np.float32(acc + v)
    return acc


def _rank_fold(parts):
    """What every reader computes: the ranks' partials folded in rank order 0..C-1."""
    acc = np.float32(parts[0])
    for p in parts[1:]:
        acc = np.float32(acc + np.float32(p))
    return acc


def _finalize(s2, s3, s4, nf):
    """moments.cu's finalize_kernel, in float32."""
    f = np.float32
    var = f(s2 / nf)
    sd = f(np.sqrt(var))
    sd3, var2 = f(sd * var), f(var * var)
    skew = f(0.0) if sd == 0 else f(f(s3 / nf) / (f(1.0) if sd3 == 0 else sd3))
    kurt = f(0.0) if var == 0 else f(f(s4 / nf) / (f(1.0) if var2 == 0 else var2))
    return var, skew, kurt


def _centred(values, mean):
    zc = np.asarray(values, np.float32) - np.float32(mean)
    zc2 = (zc * zc).astype(np.float32)
    return zc2, (zc2 * zc).astype(np.float32), (zc2 * zc2).astype(np.float32)


def global_model(z, arrangement):
    """The global forward as the cluster kernel decomposes it: each rank's sums over its
    slice, the partials folded in rank order for the mean, then the centred sums the same
    way; (4,) float32."""
    flat = np.asarray(z, np.float32).reshape(-1)
    n = flat.size
    nf = np.float32(n)
    slices = _global_slices(n, arrangement)
    mean = np.float32(_rank_fold([_seq_sum(flat[e0:e1]) for e0, e1 in slices]) / nf)
    parts = [_centred(flat[e0:e1], mean) for e0, e1 in slices]
    s2, s3, s4 = (_rank_fold([_seq_sum(p[k]) for p in parts]) for k in range(3))
    return np.array([mean, *_finalize(s2, s3, s4, nf)], np.float32)


def perdim_model(z, arrangement, dtype):
    """The per-dimension forward as the cluster kernel decomposes it: per tile, each
    rank's column sums over its rows, folded in rank order; (4, L) float32."""
    z = np.asarray(z, np.float32)
    rows, cols = z.shape
    nf = np.float32(rows)
    out = np.zeros((4, cols), np.float32)
    blocks = _perdim_blocks(rows, cols, arrangement, dtype)
    for c in range(cols):
        mine = [(b0, b1) for _r, _t, b0, b1, c0, c1 in blocks if c0 <= c < c1]
        assert len(mine) == arrangement.cluster
        mean = np.float32(_rank_fold([_seq_sum(z[b0:b1, c]) for b0, b1 in mine]) / nf)
        parts = [_centred(z[b0:b1, c], mean) for b0, b1 in mine]
        s2, s3, s4 = (_rank_fold([_seq_sum(p[k]) for p in parts]) for k in range(3))
        out[:, c] = [mean, *_finalize(s2, s3, s4, nf)]
    return out


def _z(shape, seed, constant_column=None):
    z = (np.random.RandomState(seed).randn(*shape) * 1.7 + 0.3).astype(np.float32)
    if constant_column is not None:
        z[:, constant_column] = 2.0  # exact in float32 and bfloat16: var is exactly 0
    return z


def _jax_interpret(fn):
    old = jmoments._INTERPRET
    jmoments._INTERPRET = True
    try:
        return fn()
    finally:
        jmoments._INTERPRET = old


def _close(got, want):
    """phase (f)'s tolerances: rtol 1e-5 on mean and variance, 1e-4 on skew and kurtosis,
    with an absolute floor of 1e-6 for values that are small differences of large sums."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 128), (12, 6), (37, 53), (1, 7), (300, 5)],
                         ids=["16x128", "12x6", "37x53", "1x7", "300x5"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
def test_the_global_join_model_matches_the_plain_version_and_jax(shape, dtype):
    z = _z(shape, seed=shape[0])
    tz = torch.from_numpy(z).to(dtype)
    zf = tz.float().numpy()  # the values the kernel reads, widened
    got = global_model(zf, mo.moments_arrangement("global", shape, dtype, True))
    plain = torch.stack(mo.global_moments_reference(tz)).numpy()
    jz = jnp.asarray(z).astype("bfloat16" if dtype == BF16 else "float32")
    pallas = _jax_interpret(lambda: np.array([np.asarray(v) for v in
                                              jmoments.global_moments(jz)]))
    _close(got, plain)
    _close(got, pallas)


@pytest.mark.parametrize("shape, const", [((16, 128), None), ((37, 53), None), ((9, 5), 3),
                                          ((1, 7), None), ((40, 300), None)],
                         ids=["16x128", "37x53", "constant-column", "batch-of-1", "40x300"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
def test_the_perdim_join_model_matches_the_plain_version_and_jax(shape, const, dtype):
    z = _z(shape, seed=shape[1], constant_column=const)
    tz = torch.from_numpy(z).to(dtype)
    arrangement = mo.moments_arrangement("perdim", shape, dtype, True)
    got = perdim_model(tz.float().numpy(), arrangement, dtype)
    plain = torch.stack(mo.perdim_moments_reference(tz)).numpy()
    jz = jnp.asarray(z).astype("bfloat16" if dtype == BF16 else "float32")
    pallas = _jax_interpret(lambda: np.array([np.asarray(v) for v in
                                              jmoments.perdim_moments(jz)]))
    for col in range(shape[1]):
        _close(got[:, col], plain[:, col])
        _close(got[:, col], pallas[:, col])
    if const is not None:
        assert got[:, const].tolist() == [2.0, 0.0, 0.0, 0.0]
    if shape[0] == 1:
        assert float(np.abs(got[1:]).max()) == 0.0


@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_the_perdim_model_agrees_across_cluster_sizes(cluster):
    """Every R the rule can take splits the rows differently and still gives the plain
    version's moments."""
    z = _z((64, 130), seed=cluster)
    rule = mo.moments_arrangement("perdim", (64, 130), F32, True)
    arrangement = rule._replace(cluster=cluster, slice=-(-64 // cluster))
    got = perdim_model(z, arrangement, F32)
    plain = torch.stack(mo.perdim_moments_reference(torch.from_numpy(z))).numpy()
    for col in range(130):
        _close(got[:, col], plain[:, col])


def test_a_constant_z_gives_zero_moments_in_the_model():
    z = np.full((16, 128), 0.5, np.float32)
    got = global_model(z, mo.moments_arrangement("global", (16, 128), F32, True))
    assert got.tolist() == [0.5, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("ranks", [8, 16])
def test_every_rank_folds_the_same_bits(ranks):
    """Partials of mixed magnitudes whose sum depends on the order: the rank-order fold
    that every reader makes of its own copy gives one value, bit for bit; another order
    can give another value, which is why the order is fixed."""
    rng = np.random.RandomState(ranks)
    parts = (rng.standard_normal(ranks) * 10.0 ** rng.randint(-6, 7, ranks)).astype(np.float32)
    copies = [parts.copy() for _reader in range(ranks)]  # each CTA's pushed copy
    assert len({_rank_fold(list(c)).tobytes() for c in copies}) == 1
    orders = {_rank_fold(list(parts[np.random.RandomState(s).permutation(ranks)])).tobytes()
              for s in range(50)}
    assert len(orders) > 1


# -- CPU tensors ----------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    before = ((mo.launches, mo.bwd_launches, mo.perdim_launches, mo.perdim_bwd_launches),
              {op: dict(c) for op, c in mo.moments_arrangements.items()})
    z = torch.from_numpy(_z((6, 10), seed=1)).requires_grad_(True)
    mo.global_moments(z)[3].backward()
    mo.perdim_moments(z)[3].sum().backward()
    for arrangement in (None, "cluster", "blocks"):
        mo.global_moments_packed(z.detach(), arrangement=arrangement)
        mo.perdim_moments_packed(z.detach(), arrangement=arrangement)
    after = ((mo.launches, mo.bwd_launches, mo.perdim_launches, mo.perdim_bwd_launches),
             mo.moments_arrangements)
    assert after == before
    assert set(mo.moments_arrangements) == set(mo.OPS)
    assert all(set(c) == {"cluster", "blocks"} for c in mo.moments_arrangements.values())


def test_reset_counts_zeroes_every_count(monkeypatch):
    monkeypatch.setattr(mo, "launches", 3)
    monkeypatch.setattr(mo, "perdim_bwd_launches", 2)
    monkeypatch.setattr(mo, "moments_arrangements",
                        {op: {"cluster": 5, "blocks": 1} for op in mo.OPS})
    mo.reset_counts()
    assert (mo.launches, mo.bwd_launches, mo.perdim_launches, mo.perdim_bwd_launches) == \
        (0, 0, 0, 0)
    assert mo.moments_arrangements == {op: {"cluster": 0, "blocks": 0} for op in mo.OPS}


def test_a_counted_launch_refuses_an_unknown_arrangement():
    with pytest.raises(ValueError):
        mo._launch_counted("global_forward", "warp", torch.zeros(2, 2))
    with pytest.raises(ValueError):
        mo._launch("global_backward", mo.moments_arrangement("global", (2, 2), F32, True),
                   torch.zeros(2, 2))


# -- the source -----------------------------------------------------------------------------

@pytest.mark.parametrize("needle", [
    "trustedai_cl_vae_ad_tpu/ops/moments.py:77", "_global_kernel", "_global_bwd at :174",
    ":98 (_perdim_kernel", "_perdim_bwd at :210", "What bounds it", "The design",
    "cg::this_cluster()", "map_shared_rank", "cluster.sync()", "cp.async.bulk.shared::cluster",
    "mbarrier.try_wait.parity", "mbarrier::complete_tx::bytes", "cudaLaunchKernelEx",
    "cudaLaunchAttributeClusterDimension", "cudaOccupancyMaxActiveClusters",
    "cudaFuncAttributeNonPortableClusterSizeAllowed",
    "cudaFuncAttributeMaxDynamicSharedMemorySize",
    'extern "C" int mc_global_forward(', 'extern "C" int mc_perdim_forward(',
    'extern "C" int mc_global_backward(', 'extern "C" int mc_perdim_backward(',
    'extern "C" int mc_occupancy(', 'extern "C" const char* mc_error_string(',
])
def test_the_source_carries_its_note_and_c_interface(needle):
    assert needle in SOURCE.read_text()


def test_the_sources_constants_are_the_wrappers():
    text = SOURCE.read_text()
    assert _constant("kMaxCluster") == str(mo.GLOBAL_CLUSTER)
    assert _constant("kMaxPerdimCluster") == str(mo.MAX_PERDIM_CLUSTER)
    assert _constant("kStageBudget") == "232448 - 32768"
    assert eval(_constant("kStageBudget")) == mo.STAGE_BUDGET_BYTES
    assert "static constexpr int kCols = 32 * Vec<T>::kWidth;" in text
    assert re.search(r"struct Vec<float> \{\s+static constexpr int kWidth = 4;", text)
    assert re.search(r"struct Vec<__nv_bfloat16> \{\s+static constexpr int kWidth = 8;", text)
    # a per-dimension tile's columns, each folded by one thread of the CTA
    assert int(_constant("kPerdimThreads")) >= mo.tile_columns(BF16)
    # the wrapper's argument types match the C signatures' parameter counts
    for name, count in (("mc_global_forward", 9), ("mc_perdim_forward", 10),
                        ("mc_global_backward", 8), ("mc_perdim_backward", 9)):
        sig = text[text.index(f'extern "C" int {name}('):]
        sig = sig[:sig.index(")")]
        assert sig.count(",") + 1 == count, name


def test_the_source_joins_twice_a_forward_and_reads_no_peer_after_a_barrier():
    """Two cluster barriers a forward after the arrive on entry; the only remote accesses
    are pushes made before a barrier, and the first push waits for that arrive."""
    code = "\n".join(line for line in SOURCE.read_text().splitlines()
                     if not line.lstrip().startswith("//"))
    for kernel in ("global_forward_kernel(", "perdim_forward_kernel("):
        start = code.index(kernel)
        body = code[start:code.index("__global__", start)]  # up to the next kernel
        assert body.count("cluster.sync();") == 2, kernel
        assert body.index("cluster_arrive_relaxed();") < body.index("cluster_wait();") < \
            body.index("map_shared_rank")
        assert "map_shared_rank" not in body[body.rindex("cluster.sync();"):]
    assert "barrier.cluster.arrive.relaxed.aligned" in code
    assert "barrier.cluster.wait.aligned" in code


def test_the_backwards_derive_their_coefficients_with_moments_cu_s_operations():
    """The coefficient lines of both backwards appear in moments.cu as they are here, so the
    gradients can equal moments.cu's bit for bit."""
    old = (_build.CSRC / "moments.cu").read_text()
    text = SOURCE.read_text()
    new = text[text.index("// ---- backwards"):text.index("// ---- launches")]
    lines = [line.strip() for line in new.splitlines()
             if re.match(r"\s*(c\.|const float (var|sd|sd3|inv_sd3|nf) =)", line)]
    assert len(lines) == 2 * 14  # nf, var, sd, sd3, inv_sd3 and the nine coefficients
    for line in lines:
        stripped = line.replace("c.", "c[k].") if line not in old else line
        assert line in old or stripped in old, line
    assert "return c_mean + c_var * zc + d_skew + d_kurt;" in new


def test_the_replaced_tpu_kernels_are_where_the_note_says():
    lines = (REPO / "trustedai_cl_vae_ad_tpu" / "ops" / "moments.py").read_text().splitlines()
    assert lines[76].startswith("def _global_kernel(")
    assert lines[97].startswith("def _perdim_kernel(")
    assert lines[173].startswith("def _global_bwd(")
    assert lines[209].startswith("def _perdim_bwd(")


def test_the_blocks_source_is_kept_beside_the_cluster_one():
    assert "moments.cu" in SOURCE.read_text()
    assert (_build.CSRC / "moments.cu").is_file()
    text = (_build.CSRC.parent / "ops" / "moments.py").read_text()
    assert "csrc/moments_cluster.cu" in text and "csrc/moments.cu" in text


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
    first = _build.load_library("moments_cluster")[1]
    _build._loaded.clear()
    assert _build.load_library("moments_cluster")[1] == first
    digest = _build.source_digest(SOURCE, _build.NVCC_FLAGS)
    assert Path(first).name == f"moments_cluster-{digest}.so"
    assert _build.included_headers(SOURCE) == []
    (command,) = log.read_text().splitlines()
    assert "arch=compute_90a,code=sm_90a" in command and "--fmad=false" in command
    assert command.endswith("moments_cluster.cu")


def test_build_loads_the_cluster_source_and_build_blocks_the_yardstick(monkeypatch):
    loaded = []

    class Fake:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def load(name):
        loaded.append(name)
        return Fake()

    monkeypatch.setattr(_build, "load_library", load)
    monkeypatch.setattr(mo, "_lib", None)
    monkeypatch.setattr(mo, "_blocks_lib", None)
    mo.build()
    mo.build_blocks()
    assert loaded == ["moments_cluster", "moments"]


# -- the bounds ---------------------------------------------------------------------------

@pytest.mark.parametrize("row, kernel, kind, backward", [
    (2, "_global_kernel forward", "global", False), (2, "_global_bwd", "global", True),
    (3, "_perdim_kernel forward", "perdim", False), (3, "_perdim_bwd", "perdim", True)])
def test_rows_2_and_3_of_the_bounds_are_chip_smokes(row, kernel, kind, backward):
    """kernel_bounds_torch.py's rows 2 and 3 count the bytes and operations chip_smoke.py
    counts for them at the flagship's (256, 2000) float32."""
    kb, smoke = _root_module("kernel_bounds_torch"), _root_module("chip_smoke")
    (line,) = [r for r in kb.bounds() if r["row"] == row and kernel in r["kernel"]]
    out_numel = 4 if kind == "global" else 4 * 2000
    record = smoke.moments_bounds(256 * 2000, 4, out_numel)
    key = "bwd_bound" if backward else "bound"
    assert line["bound_ms"] == pytest.approx(record[f"{key}_ms"], rel=1e-12)
    assert line["bound_by"] == record[f"{key}_by"] == "bytes"
