"""The tensor-core arrangement of the dense-layer gradient product on the CPU:
which kernel ``dense_grad`` picks (by dtype, shape and alignment alone), that
CPU tensors still take the plain version and count no launch, the CUDA
source's note and C interface, the bound of PERF.md's row 6, and the build
digest that covers the headers a source includes.

The kernel itself runs only on the card: ``tests/test_torch_kernels_gpu.py``.
"""

import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from trustedai_cl_vae_ad_tpu_torch.ops import _build
from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga

REPO = Path(__file__).resolve().parents[1]
SOURCE = _build.CSRC / "dense_grad_wgmma.cu"
HEADER = _build.CSRC / "wgmma_bf16.cuh"

# (K, M, N) of the probes and the flagship, and the card tests' small tensor-core shapes
TENSOR_CORE_SHAPES = [(768, 12800, 4000), (768, 12800, 4096), (768, 2000, 13440),
                      (768, 268800, 4000), (768, 2000, 134400), (768, 4000, 268800),
                      (3, 64, 128), (64, 384, 256), (200, 1000, 4000)]
RAGGED_SHAPES = [(5, 37, 53), (3, 1003, 250), (64, 384, 252), (64, 380, 256)]


def _meta(shape, dtype):
    """x, dz, out of (K, M, N) without memory: a meta tensor's address is 0."""
    K, M, N = shape
    return [torch.empty(s, dtype=dtype, device="meta") for s in ((K, M), (K, N), (M, N))]


@pytest.mark.parametrize("shape", TENSOR_CORE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bfloat16_at_multiples_of_8_takes_the_tensor_cores(shape):
    assert dga.dense_grad_arrangement(*_meta(shape, torch.bfloat16)) == "wgmma"


@pytest.mark.parametrize("shape", TENSOR_CORE_SHAPES[:3] + TENSOR_CORE_SHAPES[6:],
                         ids=lambda s: "x".join(map(str, s)))
def test_float32_stays_on_cuda_cores(shape):
    assert dga.dense_grad_arrangement(*_meta(shape, torch.float32)) == "cuda_core"


@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ragged_m_or_n_stays_on_cuda_cores(shape):
    assert dga.dense_grad_arrangement(*_meta(shape, torch.bfloat16)) == "cuda_core"


def _shifted(t, offset):
    buf = torch.empty(t.numel() + offset, dtype=t.dtype)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("which", ["x", "dz", "out"])
def test_a_view_off_a_16_byte_boundary_stays_on_cuda_cores(which):
    K, M, N = 16, 64, 128
    ops = {"x": torch.zeros((K, M), dtype=torch.bfloat16),
           "dz": torch.zeros((K, N), dtype=torch.bfloat16),
           "out": torch.zeros((M, N), dtype=torch.bfloat16)}
    ops = {k: _shifted(v, 0) for k, v in ops.items()}  # fresh allocations: 16-byte aligned
    assert all(t.data_ptr() % 16 == 0 for t in ops.values())
    assert dga.dense_grad_arrangement(ops["x"], ops["dz"], ops["out"]) == "wgmma"
    ops[which] = _shifted(ops[which], 1)
    assert dga.dense_grad_arrangement(ops["x"], ops["dz"], ops["out"]) == "cuda_core"


# K = 64 (2^31 - 1) is the last K whose stages of 64 rows an int counts; 2^16 x (2^15 - 1) tiles
# of 128 x 128 the last grid below 2^31 blocks (meta tensors: no memory)
_LAST_K, _LAST_M, _LAST_N = 64 * (2**31 - 1), 128 * 2**16, 128 * (2**15 - 1)


@pytest.mark.parametrize("shape,arrangement", [
    ((_LAST_K, 8, 8), "wgmma"), ((_LAST_K + 1, 8, 8), "cuda_core"),
    ((64, _LAST_M, _LAST_N), "wgmma"), ((64, _LAST_M, _LAST_N + 128), "cuda_core"),
], ids=["last_k", "k_past_an_int_of_stages", "last_grid", "grid_past_an_int"])
def test_counts_past_the_kernels_int_stay_on_cuda_cores(shape, arrangement):
    """The rule refuses what ``dgw_launch`` refuses, so the tensor-core kernel
    is never handed operands it would reject."""
    assert dga.dense_grad_arrangement(*_meta(shape, torch.bfloat16)) == arrangement


@pytest.mark.parametrize("shape", [(3, 64, 128), (16, 256, 128), (5, 37, 53)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("given_out", [False, True], ids=["new_out", "given_out"])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(shape, dtype, given_out):
    K, M, N = shape
    rng = np.random.default_rng(K + M + N)
    x = torch.from_numpy(rng.standard_normal((K, M)).astype(np.float32)).to(dtype)
    dz = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(dtype)
    out = torch.empty((M, N), dtype=dtype) if given_out else None
    before = (dict(dga.launches), dict(dga.dense_grad_arrangements))
    got = dga.dense_grad(x, dz, out=out)
    assert (dict(dga.launches), dict(dga.dense_grad_arrangements)) == before
    assert got is out if given_out else got.shape == (M, N)
    assert torch.equal(got, dga.dense_grad_reference(x, dz))


def test_the_arrangement_counter_is_separate_from_the_launch_counter():
    """``launches["dense_grad"]`` keeps counting every launch under its old key;
    the arrangements are counted beside it, not in ``launches``."""
    assert set(dga.dense_grad_arrangements) == {"wgmma", "cuda_core"}
    assert "wgmma" not in dga.launches and "dense_grad" in dga.launches


@pytest.mark.parametrize("needle", [
    "benchmarks/r11_diag.py:163 dot_only", "pallas_call at", "989 TFLOP/s", "0.0795 ms",
    "wgmma", "cp.async", "128-byte", "No split of K", "Why float32 operands stay on CUDA cores",
    '#include "wgmma_bf16.cuh"', 'extern "C" int dgw_launch(',
    'extern "C" const char* dgw_error_string(',
])
def test_the_source_carries_its_note_and_c_interface(needle):
    assert needle in SOURCE.read_text()


@pytest.mark.parametrize("needle", [
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16", "p, 1, 1, 1, 1;",
    "cp.async.cg.shared.global", "fence.proxy.async.shared::cta", "wgmma.wait_group",
    "(1ull << 62)",
])
def test_the_mainloop_header_issues_the_named_instructions(needle):
    assert needle in HEADER.read_text()


def test_the_replaced_tpu_kernel_is_where_the_note_says():
    lines = (REPO / "benchmarks" / "r11_diag.py").read_text().splitlines()
    assert 'variant == "dot_only"' in lines[158]
    assert "def kernel(" in lines[162] and "pl.pallas_call(" in lines[168]


def test_row_6_of_the_bounds_is_unchanged():
    sys.path.insert(0, str(REPO))
    try:
        import kernel_bounds_torch as kb
    finally:
        sys.path.remove(str(REPO))
    row = [r for r in kb.bounds() if r["row"] == 6][0]  # the probe's shape; then the flagship's
    K, M, N = 768, 12800, 4000
    assert row["bytes"] == 2 * (K * M + K * N + M * N) == 128_204_800
    assert row["operations"] == 2 * K * M * N == 78_643_200_000
    assert row["bound_by"] == "operations" and row["ported"]
    assert row["bound_ms"] == pytest.approx(0.0795179, rel=1e-5)


@pytest.mark.parametrize("shape", TENSOR_CORE_SHAPES[3:6], ids=lambda s: "x".join(map(str, s)))
def test_row_6_names_the_flagship_shapes_with_their_operations_bound(shape):
    sys.path.insert(0, str(REPO))
    try:
        import kernel_bounds_torch as kb
    finally:
        sys.path.remove(str(REPO))
    K, M, N = shape
    (row,) = [r for r in kb.bounds() if r["row"] == 6 and r["shapes"] == f"K={K} M={M} N={N} bf16"]
    assert row["operations"] == 2 * K * M * N and row["bound_by"] == "operations"
    assert row["bound_ms"] == pytest.approx(2 * K * M * N / 989e12 * 1e3)


# -- the build digest ---------------------------------------------------------------------------

def _tree(tmp_path):
    """k.cu includes mainloop.cuh, which includes detail.cuh; k.cu also names
    a toolkit header and, in angle brackets, a file that happens to lie beside it."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "mainloop.cuh"\n'
                                   '  #  include <beside.hpp>\n#include "missing.cuh"\n')
    (tmp_path / "mainloop.cuh").write_text('#pragma once\n#include "detail.cuh"\n')
    (tmp_path / "detail.cuh").write_text('// v1\n#include "mainloop.cuh"\n')  # a cycle
    (tmp_path / "beside.hpp").write_text("// v1\n")
    return tmp_path / "k.cu"


def test_included_headers_follow_quoted_includes_beside_the_includer(tmp_path):
    """Followed through a nested header and around a cycle; the toolkit's,
    the angle-bracket one and a missing one are not."""
    src = _tree(tmp_path)
    assert [h.name for h in _build.included_headers(src)] == ["detail.cuh", "mainloop.cuh"]


@pytest.mark.parametrize("edit", ["source", "header", "nested header", "flags"])
def test_the_digest_moves_with_every_input_of_the_build(tmp_path, edit):
    src = _tree(tmp_path)
    flags = list(_build.NVCC_FLAGS)
    before = _build.source_digest(src, flags)
    assert _build.source_digest(src, flags) == before
    if edit == "source":
        src.write_text(src.read_text() + "// edited\n")
    elif edit == "header":
        (tmp_path / "mainloop.cuh").write_text('#pragma once\n#include "detail.cuh"\n// v2\n')
    elif edit == "nested header":
        (tmp_path / "detail.cuh").write_text("// v2\n")
    else:
        flags = [*flags, "-lineinfo"]
    assert _build.source_digest(src, flags) != before


def test_a_file_the_source_does_not_include_in_quotes_does_not_move_the_digest(tmp_path):
    src = _tree(tmp_path)
    before = _build.source_digest(src, _build.NVCC_FLAGS)
    (tmp_path / "beside.hpp").write_text("// v2\n")
    (tmp_path / "unrelated.cuh").write_text("// new\n")
    assert _build.source_digest(src, _build.NVCC_FLAGS) == before


@pytest.mark.parametrize("name", ["moments", "int8_gemm_mma", "stream_score_cluster", "conv_dw"])
def test_a_source_without_package_headers_keeps_its_digest(name):
    """No rebuild of the sources that include no header of the package: their
    digest is the one of source and flags alone. (dense_grad_adam.cu now
    includes adam_step.cuh: tests/test_torch_dense_grad_adam_tc.py.)"""
    import hashlib

    src = _build.CSRC / f"{name}.cu"
    assert _build.included_headers(src) == []
    old = hashlib.sha256(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert _build.source_digest(src, _build.NVCC_FLAGS) == old


def test_the_wgmma_source_digest_covers_its_mainloop_header():
    assert _build.included_headers(SOURCE) == [HEADER.resolve()]


def _fake_nvcc(tmp_path, monkeypatch):
    """A stand-in for nvcc that records each command line and writes an empty
    library; loads are served from a fresh cache into ``tmp_path``."""
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
    return log


def test_a_library_is_built_once_under_its_digest(tmp_path, monkeypatch):
    log = _fake_nvcc(tmp_path, monkeypatch)
    assert _build.load_library("dense_grad_wgmma") == _build.load_library("dense_grad_wgmma")
    _build.load_library("moments")
    commands = log.read_text().splitlines()
    assert len(commands) == 2  # the second load of a source is served from the cache
    assert commands[0].split() == [*_build.NVCC_FLAGS, "-o", commands[0].split()[-2], str(SOURCE)]
    assert commands[1].endswith("moments.cu")
    for name in ("dense_grad_wgmma", "moments"):
        path = _build.library_paths[name]
        digest = _build.source_digest(_build.CSRC / f"{name}.cu", _build.NVCC_FLAGS)
        assert path.name == f"{name}-{digest}.so"
        assert path.is_file()


def test_an_edit_to_the_header_rebuilds_the_source_that_includes_it(tmp_path, monkeypatch):
    """A copy of the two files in a private csrc: editing the header gives the
    next process (a fresh cache) a new library; restoring it finds the old one."""
    log = _fake_nvcc(tmp_path, monkeypatch)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in (SOURCE, HEADER):
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.load_library("dense_grad_wgmma")[1]
    header = csrc / HEADER.name
    header.write_text(header.read_text() + "// edited\n")
    _build._loaded.clear()
    second = _build.load_library("dense_grad_wgmma")[1]
    header.write_bytes(HEADER.read_bytes())
    _build._loaded.clear()
    third = _build.load_library("dense_grad_wgmma")[1]
    assert first != second and third == first
    assert len(log.read_text().splitlines()) == 2  # the restored header needs no build
