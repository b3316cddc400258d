"""Kernel 10's tensor-core arrangement on the CPU: the chunked product's plain
version against JAX's int8 dot chunk by chunk, which kernel ``int8_gemm`` and
``int8_gemm_chunked`` pick (by dtype, shape and alignment alone), that CPU
tensors take the plain versions and count no launch, ``_int8_partials`` in
one chunked call, a model of ``csrc/int8_gemm_mma.cu``'s index arithmetic
(the ``cp.async`` staging, the swizzle, ``ldmatrix`` and the ``mma.sync``
m16n8k32 fragments, the K splits) that reproduces ``x @ w.T``, and the
source's note, C interface and build.

The kernel itself runs only on the card: ``tests/test_torch_kernels_gpu.py``.
"""

import re
import stat
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from trustedai_cl_vae_ad_tpu_torch.ops import _build
from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig
from trustedai_cl_vae_ad_tpu_torch.ops import quant
from trustedai_cl_vae_ad_tpu_torch.testing import shifted

REPO = Path(__file__).resolve().parents[1]
SOURCE = _build.CSRC / "int8_gemm_mma.cu"
SAFE_K = 1 << 17


def _rand_i8(shape, seed):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype(np.int8)


def _jax_chunks(x, w, chunk):
    """JAX's int8 x int8 -> int32 dot over each chunk of K (w is (N, K))."""
    k = x.shape[1]
    return [np.asarray(lax.dot_general(jnp.asarray(x[:, s:s + chunk]),
                                       jnp.asarray(w[:, s:s + chunk]),
                                       (((1,), (1,)), ((), ())),
                                       preferred_element_type=jnp.int32))
            for s in range(0, k, chunk)]


# (M, K, N, chunk): ragged K in chunks of 128, K past one chunk of 131072, a chunk longer than K
JAX_CASES = [(3, 1003, 37, 128), (16, 300, 40, 128), (2, 140000, 3, SAFE_K), (1, 64, 5, SAFE_K)]


@pytest.mark.parametrize("m, k, n, chunk", JAX_CASES,
                         ids=["x".join(map(str, c)) for c in JAX_CASES])
def test_the_chunked_plain_version_equals_jax_chunk_by_chunk(m, k, n, chunk):
    x, w = _rand_i8((m, k), k), _rand_i8((n, k), n)
    got = ig.int8_gemm_chunked_reference(torch.from_numpy(x), torch.from_numpy(w), chunk)
    want = _jax_chunks(x, w, chunk)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(want), m, n)
    for part, dot in zip(got, want):
        np.testing.assert_array_equal(part.numpy(), dot)


@pytest.mark.parametrize("sign", [1, -1], ids=["plus", "minus"])
def test_saturated_rows_equal_jax_in_chunks_of_131072(sign):
    """Rows of +-127 over two chunks of 131072 (the largest sums a chunk can hold) and a
    random row beside them."""
    k = 2 * SAFE_K + 32
    x = np.full((3, k), 127, np.int8)
    x[1] = -127
    x[2] = _rand_i8((k,), 1)
    w = np.full((2, k), 127 * sign, np.int8)
    got = ig.int8_gemm_chunked_reference(torch.from_numpy(x), torch.from_numpy(w), SAFE_K)
    for part, dot in zip(got, _jax_chunks(x, w, SAFE_K)):
        np.testing.assert_array_equal(part.numpy(), dot)
    assert int(got[0, 0, 0]) == sign * 127 * 127 * SAFE_K and int(got[0, 1, 1]) == -int(got[0, 0, 0])


def test_the_chunked_call_on_cpu_tensors_takes_the_plain_version_and_counts_nothing():
    x, w = torch.from_numpy(_rand_i8((5, 1000), 1)), torch.from_numpy(_rand_i8((7, 1000), 2))
    before = (ig.launches, dict(ig.int8_gemm_arrangements))
    got = ig.int8_gemm_chunked(x, w, 256)
    single = ig.int8_gemm(x, w, 256, 512)
    assert (ig.launches, dict(ig.int8_gemm_arrangements)) == before
    assert torch.equal(got, ig.int8_gemm_chunked_reference(x, w, 256))
    assert got.shape == (4, 5, 7) and torch.equal(got[1], single)


@pytest.mark.parametrize("chunk", [0, -16])
def test_a_chunk_that_is_not_positive_raises(chunk):
    x = torch.zeros((2, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="chunk"):
        ig.int8_gemm_chunked(x, x, chunk)
    with pytest.raises(ValueError, match="chunk"):
        ig.int8_gemm_chunked_reference(x, x, chunk)


def test_the_arrangement_counter_is_separate_from_the_launch_counter():
    assert set(ig.int8_gemm_arrangements) == {"mma", "cuda_core"}
    assert isinstance(ig.launches, int)


# -- the rule ---------------------------------------------------------------------------------

def _meta(m, k, n):
    """x (m, k) and w (n, k) int8 without memory: a meta tensor's address is 0."""
    return (torch.empty((m, k), dtype=torch.int8, device="meta"),
            torch.empty((n, k), dtype=torch.int8, device="meta"))


# the flagship's two quantized Dense layers at 16 cameras and 1 frame, in chunks of 131072,
# and the archived probe's shape in one range
PATH_SHAPES = [(16, 268800, 4000), (1, 268800, 4000), (16, 2000, 134400), (1, 2000, 134400)]


@pytest.mark.parametrize("m, k, n", PATH_SHAPES, ids=["x".join(map(str, s)) for s in PATH_SHAPES])
def test_the_path_shapes_take_the_tensor_cores(m, k, n):
    assert ig.int8_gemm_arrangement(*_meta(m, k, n), 0, k, SAFE_K) == "mma"


def test_the_probe_shape_takes_the_tensor_cores():
    assert ig.int8_gemm_arrangement(*_meta(32, 268800, 4096)) == "mma"


@pytest.mark.parametrize("which", ["x", "w"])
def test_a_view_off_a_16_byte_boundary_takes_the_cuda_cores(which):
    ops = {"x": shifted(torch.zeros((4, 64), dtype=torch.int8), 0),
           "w": shifted(torch.zeros((6, 64), dtype=torch.int8), 0)}
    assert all(t.data_ptr() % 16 == 0 for t in ops.values())
    assert ig.int8_gemm_arrangement(ops["x"], ops["w"]) == "mma"
    ops[which] = shifted(ops[which], 1)
    assert ops[which].data_ptr() % 16 and ops[which].is_contiguous()
    assert ig.int8_gemm_arrangement(ops["x"], ops["w"]) == "cuda_core"


@pytest.mark.parametrize("m, k, n, k0, k1, chunk, arrangement", [
    (5, 1003, 37, 0, None, None, "cuda_core"),  # K off a multiple of 16
    (5, 8, 37, 0, None, None, "cuda_core"),  # the tiny models' decoder Dense
    (5, 1008, 37, 0, None, None, "mma"),
    (5, 1024, 37, 5, 1000, None, "cuda_core"),  # a range that starts and ends off 16
    (5, 1024, 37, 16, 1000, None, "cuda_core"),  # ends off 16
    (5, 1024, 37, 16, 1008, None, "mma"),
    (5, 1024, 37, 0, None, 100, "cuda_core"),  # a chunk off 16
    (5, 1024, 37, 0, None, 112, "mma"),
    (5, 1024, 37, 0, None, 4096, "mma"),  # a chunk longer than the range is the range
    (5, 65536 * 16, 3, 0, None, 16, "cuda_core"),  # 65536 chunks: past the grid's y
    (5, 65535 * 16, 3, 0, None, 16, "mma"),
    (65535 * 32 + 1, 16, 3, 0, None, None, "cuda_core"),  # 65536 tiles of 32 rows: past z
    (65535 * 32, 16, 3, 0, None, None, "mma"),
], ids=["k_1003", "k_8", "k_1008", "range_5_1000", "range_16_1000", "range_16_1008",
        "chunk_100", "chunk_112", "chunk_past_the_range", "65536_chunks", "65535_chunks",
        "65536_m_tiles", "65535_m_tiles"])
def test_the_rule_on_shapes_ranges_and_chunks(m, k, n, k0, k1, chunk, arrangement):
    assert ig.int8_gemm_arrangement(*_meta(m, k, n), k0, k1, chunk) == arrangement


# -- ops/quant.py's one call a quantized Dense ----------------------------------------------

@pytest.mark.parametrize("k, safe_k", [(300, 128), (300, SAFE_K), (268800, SAFE_K), (2000, SAFE_K)],
                         ids=["300-in-128", "300-one-chunk", "encoder-k", "decoder-k"])
def test_int8_partials_are_the_chunks_in_order(k, safe_k):
    x, w = _rand_i8((2, k), 3), _rand_i8((3, k), 4)
    with mock.patch.object(quant, "_I32_SAFE_K", safe_k):
        before = ig.launches
        parts = quant._int8_partials(torch.from_numpy(x), torch.from_numpy(w))
    assert ig.launches == before
    assert len(parts) == -(-k // safe_k)
    for part, dot in zip(parts, _jax_chunks(x, w, safe_k)):
        assert part.dtype == torch.int32 and part.shape == (2, 3)
        np.testing.assert_array_equal(part.numpy(), dot)


# -- a model of csrc/int8_gemm_mma.cu's index arithmetic ---------------------------------------

def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


THREADS, ROWS, STAGE_K, STAGES = 256, 128, 128, 4
CHUNKS = STAGE_K // 16


def test_the_model_uses_the_sources_constants():
    assert (_constant("kThreads"), _constant("kRows"), _constant("kStageK"),
            _constant("kStages")) == (THREADS, ROWS, STAGE_K, STAGES)
    text = SOURCE.read_text()
    for needle in ("r * kStageK + ((c ^ (r & 7)) << 4)", "const int cc = tid % kChunks;",
                   "const int r_w = tid / kChunks;", "r_w + j * (kThreads / kChunks)",
                   "const bool x_copies = tid < MT * kChunks;",
                   "const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;",
                   "const int a_half = lane >> 4;",
                   "const int b_row = (lane & 7) + (NT > 1 ? 8 * (lane >> 4) : 0);",
                   "const int b_half = (lane >> 3) & 1;",
                   "swizzled(a_row, 2 * ks + a_half)", "swizzled(8 * j + b_row, 2 * ks + b_half)",
                   "const long long n = n0 + warp * 16 + g + (i >= 2 ? 8 : 0);",
                   "const long long m = m0 + 8 * j + 2 * t + (i & 1);"):
        assert needle in text, needle


def _swizzled(r, c):
    return r * STAGE_K + ((c ^ (r & 7)) << 4)


def _staged(nt):
    """(operand, row, chunk, byte offset in the operand's tile) of every cp.async of a stage."""
    copies = []
    for tid in range(THREADS):
        cc, r_w = tid % CHUNKS, tid // CHUNKS
        for j in range(ROWS * CHUNKS // THREADS):
            r = r_w + j * (THREADS // CHUNKS)
            copies.append(("w", r, cc, _swizzled(r, cc)))
        if tid < 8 * nt * CHUNKS:
            copies.append(("x", r_w, cc, _swizzled(r_w, cc)))
    return copies


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_every_byte_of_a_stage_is_staged_exactly_once(nt):
    copies = _staged(nt)
    for operand, rows in (("w", ROWS), ("x", 8 * nt)):
        mine = [c for c in copies if c[0] == operand]
        assert sorted((r, c) for _, r, c, _ in mine) == [(r, c) for r in range(rows)
                                                         for c in range(CHUNKS)]
        assert sorted(off for *_, off in mine) == list(range(0, rows * STAGE_K, 16))


def test_an_ldmatrix_phase_reads_eight_different_bank_groups():
    """8 rows (a multiple of 8 onward) at one logical chunk: 8 different 16-byte columns."""
    for r0 in range(0, ROWS, 8):
        for c in range(CHUNKS):
            assert len({_swizzled(r0 + i, c) % STAGE_K for i in range(8)}) == 8


def _ldmatrix(smem, addrs, count):
    """ldmatrix .m8n8 .b16: lanes 8i..8i+7 give matrix i's row addresses; lane L receives
    the 4 bytes at byte 4 (L % 4) of row L / 4 of each matrix. Returns (32, count, 4) int8."""
    out = np.empty((32, count, 4), np.int8)
    for lane in range(32):
        for i in range(count):
            row = addrs[8 * i + lane // 4]
            assert row % 16 == 0
            out[lane, i] = smem[row + 4 * (lane % 4):row + 4 * (lane % 4) + 4]
    return out


def _mma(d, a, b):
    """mma.m16n8k32.row.col s8 -> s32 from the 32 lanes' fragments: A (row, k) in lane
    4 (row % 8) + (k % 16) / 4, register (row >= 8) + 2 (k >= 16), byte k % 4; B (k, n) in
    lane 4 n + (k % 16) / 4, register k >= 16, byte k % 4; D (row, col) in lane
    4 (row % 8) + col / 2, register 2 (row >= 8) + col % 2. d is (32, 4) int64."""
    A = np.empty((16, 32), np.int64)
    B = np.empty((32, 8), np.int64)
    for row in range(16):
        for k in range(32):
            A[row, k] = a[4 * (row % 8) + (k % 16) // 4, int(row >= 8) + 2 * int(k >= 16), k % 4]
    for k in range(32):
        for n in range(8):
            B[k, n] = b[4 * n + (k % 16) // 4, int(k >= 16), k % 4]
    D = A @ B
    for lane in range(32):
        for i in range(4):
            d[lane, i] += D[lane // 4 + 8 * (i >= 2), 2 * (lane % 4) + (i & 1)]


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_the_fragment_layout_reproduces_the_product_of_a_stage(nt):
    """One stage as the kernel computes it: the copies place w (128 x 128 B) and x (8 nt x
    128 B) in their swizzled tiles, every warp reads its fragments with ldmatrix at the
    kernel's lane addresses and accumulates m16n8k32 products, and the epilogue's map puts
    each accumulator at out[m, n]; the result is x @ w.T."""
    mt = 8 * nt
    rng = np.random.RandomState(nt)
    w = rng.randint(-9, 10, (ROWS, STAGE_K)).astype(np.int8)
    x = rng.randint(-9, 10, (mt, STAGE_K)).astype(np.int8)
    ws = np.full(ROWS * STAGE_K, 99, np.int8)
    xs = np.full(mt * STAGE_K, 99, np.int8)
    for operand, r, c, off in _staged(nt):
        tile, src = (ws, w) if operand == "w" else (xs, x)
        tile[off:off + 16] = src[r, 16 * c:16 * c + 16]
    out = np.zeros((mt, ROWS), np.int64)
    for warp in range(8):
        acc = np.zeros((nt, 32, 4), np.int64)
        for ks in range(STAGE_K // 32):
            lanes = range(32)
            a_addr = [_swizzled(warp * 16 + (ln & 7) + ((ln >> 3) & 1) * 8, 2 * ks + (ln >> 4))
                      for ln in lanes]
            a = _ldmatrix(ws, a_addr, 4)
            b = np.empty((nt, 32, 2, 4), np.int8)
            if nt == 1:
                b[0] = _ldmatrix(xs, [_swizzled(ln & 7, 2 * ks + ((ln >> 3) & 1))
                                      for ln in lanes], 2)
            else:
                for j in range(0, nt, 2):
                    r = _ldmatrix(xs, [_swizzled(8 * j + (ln & 7) + 8 * (ln >> 4),
                                                 2 * ks + ((ln >> 3) & 1)) for ln in lanes], 4)
                    b[j], b[j + 1] = r[:, 0:2], r[:, 2:4]
            for j in range(nt):
                _mma(acc[j], a, b[j])
        for j in range(nt):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for i in range(4):
                    out[8 * j + 2 * t + (i & 1), warp * 16 + g + (8 if i >= 2 else 0)] = \
                        acc[j, lane, i]
    np.testing.assert_array_equal(out, x.astype(np.int64) @ w.astype(np.int64).T)


def _plan(m, n, k0, k1, chunk, sms=132, per_sm=2, waves=8, min_stages=16):
    """The launcher's K splits (as ``launch`` in the source computes them): returns the
    (chunk, begin, end) of every split and whether the splits meet in atomics."""
    span = k1 - k0
    chunk = min(chunk, span)
    chunks = -(-span // chunk)
    full = -(-chunk // STAGE_K)
    last = -(-(span - (chunks - 1) * chunk) // STAGE_K)
    total = (chunks - 1) * full + last
    tiles = -(-n // ROWS) * -(-m // (8 if m <= 8 else 16 if m <= 16 else 32))
    want = -(-sms * per_sm * waves // tiles)
    split = full
    if want > chunks:
        split = min(max(-(-total // want), min_stages), full)
    per_chunk = -(-full // split)
    grid_y = (chunks - 1) * per_chunk + -(-last // split)
    splits = []
    for y in range(grid_y):
        c, s = y // per_chunk, y % per_chunk
        cb = k0 + c * chunk
        ce = min(cb + chunk, k1)
        b = cb + s * split * STAGE_K
        splits.append((c, b, min(b + split * STAGE_K, ce)))
    return splits, grid_y > chunks


def test_the_plan_model_uses_the_sources_constants():
    assert (_constant("kWaves"), _constant("kMinSplitStages")) == (8, 16)
    assert "const int c = blockIdx.y / splits_per_chunk, s = blockIdx.y % splits_per_chunk;" in \
        SOURCE.read_text()


@pytest.mark.parametrize("m, n, k0, k1, chunk, per_sm, atomic", [
    (16, 4000, 0, 268800, SAFE_K, 3, True), (1, 4000, 0, 268800, SAFE_K, 3, True),
    (32, 4096, 0, 268800, 268800, 2, True), (16, 134400, 0, 2000, SAFE_K, 3, False),
    (1, 134400, 0, 2000, SAFE_K, 3, False), (5, 40, 256, 7936, 4096, 2, True),
    (1, 7, 0, 4112, 2048, 2, False),
], ids=["encoder-16", "encoder-1", "probe", "decoder-16", "decoder-1", "range", "chunk-of-16"])
def test_every_split_lies_in_one_chunk_and_the_splits_cover_the_range(m, n, k0, k1, chunk, per_sm,
                                                                      atomic):
    splits, atomics = _plan(m, n, k0, k1, chunk, per_sm=per_sm)
    assert atomics == atomic and len(splits) <= 65535
    covered = []
    for c, b, e in splits:
        assert b < e and k0 + c * min(chunk, k1 - k0) <= b and e <= min(
            k0 + (c + 1) * min(chunk, k1 - k0), k1)
        covered.extend(range(b, e, 16))
    assert covered == list(range(k0, k1, 16))


# -- the source ------------------------------------------------------------------------------

@pytest.mark.parametrize("needle", [
    "benchmarks/r4_int8_gemm.py:45", "make_pallas_gemm", "1979e12 / 3.35e12", "0.321 ms",
    "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32", "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
    "cp.async.cg.shared.global [%0], [%1], 16, %2;", "cp.async.wait_group", "src-size 0", "atomicAdd", "cudaMemsetAsync",
    'extern "C" int i8mma_launch(', 'extern "C" const char* i8mma_error_string(',
])
def test_the_source_carries_its_note_and_c_interface(needle):
    assert needle in SOURCE.read_text()


def test_the_mma_wraps_instead_of_saturating():
    """The sums must wrap modulo 2^32, as the plain version and the CUDA-core kernel define
    them: no instruction of the source carries .satfinite."""
    code = [line for line in SOURCE.read_text().splitlines() if not line.lstrip().startswith("//")]
    assert not any("satfinite" in line for line in code)


def test_the_replaced_tpu_kernel_is_where_the_note_says():
    lines = (REPO / "benchmarks" / "r4_int8_gemm.py").read_text().splitlines()
    assert lines[44].strip().startswith("def kernel(")
    assert lines[38].startswith("def make_pallas_gemm(")


def test_the_cuda_core_source_is_named_beside_the_tensor_core_one():
    assert "csrc/int8_gemm.cu" in SOURCE.read_text()
    assert "int8_gemm_mma.cu" in (_build.CSRC.parent / "ops" / "int8_gemm.py").read_text()


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
    first = _build.load_library("int8_gemm_mma")[1]
    _build._loaded.clear()
    assert _build.load_library("int8_gemm_mma")[1] == first
    digest = _build.source_digest(SOURCE, _build.NVCC_FLAGS)
    assert Path(first).name == f"int8_gemm_mma-{digest}.so"
    assert _build.included_headers(SOURCE) == []
    (command,) = log.read_text().splitlines()
    assert "arch=compute_90a,code=sm_90a" in command and command.endswith("int8_gemm_mma.cu")
