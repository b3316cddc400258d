"""The tensor-core arrangement of the convolution weight gradient on the CPU:
which kernel ``conv_dw`` picks (by dtype, shape and alignment alone), that CPU
tensors still take the plain version and count no launch, the plain version
against the archived JAX kernel at shapes the tensor cores take, the CUDA
source's note and C interface, its build digest, and the bound of PERF.md's
row 11.

The kernel itself runs only on the card: ``tests/test_torch_kernels_gpu.py``.
"""

import stat
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import load_r18_probe, np_to_torch_exact
from trustedai_cl_vae_ad_tpu_torch.ops import _build
from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw
from trustedai_cl_vae_ad_tpu_torch.probes import r18
from trustedai_cl_vae_ad_tpu_torch.testing import shifted

REPO = Path(__file__).resolve().parents[1]
SOURCE = _build.CSRC / "conv_dw_wgmma.cu"
HEADER = _build.CSRC / "wgmma_bf16.cuh"

# (B, H, W, CI, CO): the flagship's conv2 at batch 768 and 256, and the card tests' shapes:
# one line, two images, a second (partial) tile of CI, CO = 8, two tiles of CO
TENSOR_CORE_SHAPES = [(768, 112, 150, 32, 64), (256, 112, 150, 32, 64), (1, 4, 150, 32, 64),
                      (2, 112, 150, 32, 64), (3, 4, 70, 40, 64), (2, 8, 12, 8, 8),
                      (1, 4, 140, 32, 128)]
# conv1 (CI = 3), channel counts that are no multiple of 8
RAGGED_SHAPES = [(768, 224, 300, 3, 32), (2, 8, 12, 3, 8), (3, 4, 70, 40, 70), (2, 6, 8, 12, 16),
                 (2, 6, 8, 16, 20)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


def _meta(shape, dtype):
    """x and dy of (B, H, W, CI, CO) without memory: a meta tensor's address is 0."""
    b, h, w, ci, co = shape
    return (torch.empty((b, h, w, ci), dtype=dtype, device="meta"),
            torch.empty((b, h // 2, w // 2, co), dtype=dtype, device="meta"))


@pytest.mark.parametrize("shape", TENSOR_CORE_SHAPES, ids=_ids(TENSOR_CORE_SHAPES))
def test_bfloat16_at_multiples_of_8_takes_the_tensor_cores(shape):
    assert cdw.conv_dw_arrangement(*_meta(shape, torch.bfloat16)) == "wgmma"


@pytest.mark.parametrize("shape", TENSOR_CORE_SHAPES, ids=_ids(TENSOR_CORE_SHAPES))
def test_float32_stays_on_cuda_cores(shape):
    """wgmma has no float32 input; tf32 would be another function."""
    assert cdw.conv_dw_arrangement(*_meta(shape, torch.float32)) == "cuda_core"


@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=_ids(RAGGED_SHAPES))
def test_channel_counts_off_a_multiple_of_8_stay_on_cuda_cores(shape):
    assert cdw.conv_dw_arrangement(*_meta(shape, torch.bfloat16)) == "cuda_core"


@pytest.mark.parametrize("which", ["x", "dy"])
def test_a_view_off_a_16_byte_boundary_stays_on_cuda_cores(which):
    b, h, w, ci, co = 2, 8, 12, 8, 16
    ops = {"x": shifted(torch.zeros((b, h, w, ci), dtype=torch.bfloat16), 0),
           "dy": shifted(torch.zeros((b, h // 2, w // 2, co), dtype=torch.bfloat16), 0)}
    assert all(t.data_ptr() % 16 == 0 for t in ops.values())
    assert cdw.conv_dw_arrangement(ops["x"], ops["dy"]) == "wgmma"
    ops[which] = shifted(ops[which], 1)
    assert ops[which].data_ptr() % 16 and ops[which].is_contiguous()
    assert cdw.conv_dw_arrangement(ops["x"], ops["dy"]) == "cuda_core"


@pytest.mark.parametrize("shape,arrangement", [
    ((2**31 - 1, 2, 2, 8, 8), "wgmma"), ((2**31, 2, 2, 8, 8), "cuda_core"),
    ((3, 2**15, 2**16, 8, 8), "wgmma"), ((4, 2**15, 2**16, 8, 8), "cuda_core"),
    ((1, 2, 2, 8192, 8192), "wgmma"), ((1, 2, 2, 16384, 16384), "cuda_core"),
    ((1, 2, 2**30 - 2, 8, 8), "wgmma"), ((1, 2, 2**30, 8, 8), "cuda_core"),
], ids=["last_batch", "batch_past_an_int", "last_positions", "positions_past_an_int",
        "9_ci_co_below_2_31", "9_ci_co_past_2_31", "last_width", "width_past_the_limit"])
def test_counts_past_the_kernels_ints_stay_on_cuda_cores(shape, arrangement):
    """The rule refuses what ``cdw_wgmma_launch`` refuses (meta tensors: no memory)."""
    assert cdw.conv_dw_arrangement(*_meta(shape, torch.bfloat16)) == arrangement


@pytest.mark.parametrize("shape", [(1, 4, 150, 32, 64), (2, 8, 12, 8, 8), (3, 4, 70, 40, 70)],
                         ids=_ids([(1, 4, 150, 32, 64), (2, 8, 12, 8, 8), (3, 4, 70, 40, 70)]))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(shape, dtype):
    b, h, w, ci, co = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal((b, h, w, ci)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((b, h // 2, w // 2, co)).astype(np.float32)).to(dtype)
    before = (cdw.launches, dict(cdw.conv_dw_arrangements))
    got = cdw.conv_dw(x, dy)
    assert (cdw.launches, dict(cdw.conv_dw_arrangements)) == before
    assert torch.equal(got, cdw.conv_dw_reference(x, dy))


def test_the_arrangement_counter_is_separate_from_the_launch_counter():
    """``launches`` keeps counting every launch; the arrangements are counted beside it."""
    assert set(cdw.conv_dw_arrangements) == {"wgmma", "cuda_core"}
    assert isinstance(cdw.launches, int)


# shapes the tensor cores take, small enough for the Pallas kernel in interpret mode: a stage
# boundary crossed inside a line (OW = 70), a second tile of CI, two tiles of CO
JAX_SHAPES = [(1, 4, 140, 32, 64), (2, 6, 10, 40, 8), (1, 4, 12, 8, 128)]


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=_ids(JAX_SHAPES))
def test_the_plain_version_equals_the_pallas_kernel_where_the_tensor_cores_take_it(
        monkeypatch, tmp_path, shape):
    """What the wgmma kernel is held against on the card, against the archived
    JAX kernel on the same bfloat16 operands: products of bfloat16 values are
    exact in float32, so only the order of the float32 sums differs."""
    probe = load_r18_probe(monkeypatch, tmp_path)
    x, _w, dy = r18.check_operands(shape, seed=3)
    xj, dyj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    xt, dyt = np_to_torch_exact(np.asarray(xj)), np_to_torch_exact(np.asarray(dyj))
    assert cdw.conv_dw_arrangement(shifted(xt, 0), shifted(dyt, 0)) == "wgmma"
    want = np.asarray(probe.conv_dw_pallas(xj, dyj))
    got = cdw.conv_dw(xt, dyt)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("needle", [
    "benchmarks/r18_conv_dw.py::_dw_kernel", "conv_dw_pallas", "989 TFLOP/s", "0.370 ms",
    "wgmma.mma_async", "m64n128k16", "cp.async", "128-byte swizzle", "0 * NaN is not 0",
    "index order", "No float atomics", '#include "wgmma_bf16.cuh"',
    'extern "C" long long cdw_wgmma_splits(', 'extern "C" int cdw_wgmma_launch(',
    'extern "C" const char* cdw_wgmma_error_string(',
])
def test_the_source_carries_its_note_and_c_interface(needle):
    assert needle in SOURCE.read_text()


@pytest.mark.parametrize("needle", ["wgmma_m64n128k16_mn(", "swizzled_offset(", "cp_async_16(",
                                    "make_descriptor(", "fence_proxy_async()", "wgmma_wait<0>()"])
def test_the_source_uses_the_mainloop_headers_primitives(needle):
    assert needle in SOURCE.read_text()


def test_the_header_issues_the_instruction_that_becomes_hgmma():
    """The SASS count of HGMMA is checked on the card (chip_smoke.py phase s)."""
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in HEADER.read_text()


def test_the_replaced_tpu_kernel_is_where_the_note_says():
    lines = (REPO / "benchmarks" / "r18_conv_dw.py").read_text().splitlines()
    assert lines[52].startswith("def _dw_kernel(")
    assert lines[85].startswith("def conv_dw_pallas(") and "pl.pallas_call(" in lines[99]


def test_the_cuda_core_source_points_at_the_tensor_core_one():
    assert "conv_dw_wgmma.cu" in (_build.CSRC / "conv_dw.cu").read_text()


def test_the_source_digest_covers_its_mainloop_header():
    assert _build.included_headers(SOURCE) == [HEADER.resolve()]


def test_the_library_is_built_once_under_a_digest_of_source_and_header(tmp_path, monkeypatch):
    """A stand-in nvcc records each command line; an edit to the header gives
    a new library, restoring it finds the old one."""
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
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in (SOURCE, HEADER):
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.load_library("conv_dw_wgmma")[1]
    assert _build.load_library("conv_dw_wgmma")[1] == first
    digest = _build.source_digest(csrc / SOURCE.name, _build.NVCC_FLAGS)
    assert Path(first).name == f"conv_dw_wgmma-{digest}.so"
    header = csrc / HEADER.name
    header.write_text(header.read_text() + "// edited\n")
    _build._loaded.clear()
    second = _build.load_library("conv_dw_wgmma")[1]
    header.write_bytes(HEADER.read_bytes())
    _build._loaded.clear()
    assert _build.load_library("conv_dw_wgmma")[1] == first != second
    commands = log.read_text().splitlines()
    assert len(commands) == 2 and all(c.endswith("conv_dw_wgmma.cu") for c in commands)


def _bounds():
    sys.path.insert(0, str(REPO))
    try:
        import kernel_bounds_torch as kb
    finally:
        sys.path.remove(str(REPO))
    return [r for r in kb.bounds() if r["row"] == 11]


@pytest.mark.parametrize("layer,shape,nbytes,ms", [
    ("conv1", (768, 224, 300, 3, 32), 1_135_414_656, 0.338930),
    ("conv2", (768, 112, 150, 32, 64), 1_238_704_128, 0.369762),
])
def test_row_11_of_the_bounds_is_unchanged(layer, shape, nbytes, ms):
    """The function's bound, whichever kernel computes it: x and dy read once,
    dW written once, 2 * 9 CI CO operations a position."""
    b, h, w, ci, co = shape
    (row,) = [r for r in _bounds() if layer in r["kernel"]]
    assert row["bytes"] == 2 * b * (h * w * ci + (h // 2) * (w // 2) * co) + 4 * 9 * ci * co
    assert row["bytes"] == nbytes
    assert row["operations"] == 2 * b * (h // 2) * (w // 2) * 9 * ci * co
    assert row["bound_by"] == "bytes" and row["ported"]
    assert row["bound_ms"] == pytest.approx(ms, rel=1e-5)
    assert row["bound_ms"] == pytest.approx(r18.kernel_bound(b, h, w, ci, co, 2)[0])
