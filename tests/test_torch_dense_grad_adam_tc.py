"""The tensor-core arrangement of the fused dense update (kernels 4 and 5) on
the CPU: which kernel ``fused_dense_grad_adam`` picks (by dtype, shape and
alignment alone), that CPU tensors still take the plain version and count no
launch, the CUDA source's note and C interface, the shared step header, and
the build digest that covers that header for both sources that include it.

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
from trustedai_cl_vae_ad_tpu_torch.probes import r11

REPO = Path(__file__).resolve().parents[1]
SOURCE = _build.CSRC / "dense_grad_adam_wgmma.cu"
CUDA_CORE_SOURCE = _build.CSRC / "dense_grad_adam.cu"
STEP = _build.CSRC / "adam_step.cuh"
MAINLOOP = _build.CSRC / "wgmma_bf16.cuh"
ADAM = r11.ADAM

# (K, M, N): the probe's shape, the encoder Dense in the port's (out, in) layout, and M and
# N off 128 (K multiples of 8, so x may be (M, K)); every shape the probes drive is checked
# by test_the_probes_shapes_and_the_port_layout_are_on_the_rule
TENSOR_CORE_SHAPES = [r11.DIAG_SHAPE, (768, 4000, 268800), (64, 384, 136), (104, 256, 200)]
# a K that is no multiple of 8: x (K, M) still takes the tensor cores, x (M, K) does not
K_TAILS = [(3, 64, 128), (100, 256, 200)]
# N off 8, M off 8
RAGGED_SHAPES = [(64, 384, 252), (64, 380, 256)]
LAYOUTS = (False, True)  # x (K, M), x (M, K)
NAMES = ("x", "dz", "w", "mu", "nu")


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


def _meta(shape, dtype, x_transposed=False):
    """x, dz, w, mu, nu of (K, M, N) without memory: a meta tensor's address is 0."""
    K, M, N = shape
    x = (M, K) if x_transposed else (K, M)
    return [torch.empty(s, dtype=dtype, device="meta") for s in (x, (K, N), (M, N), (M, N),
                                                                  (M, N))]


@pytest.mark.parametrize("x_transposed", [False, True], ids=["x_km", "x_mk"])
@pytest.mark.parametrize("shape", TENSOR_CORE_SHAPES, ids=_ids(TENSOR_CORE_SHAPES))
def test_bfloat16_on_the_rule_takes_the_tensor_cores(shape, x_transposed):
    ops = _meta(shape, torch.bfloat16, x_transposed)
    assert dga.fused_arrangement(*ops, x_transposed=x_transposed) == "wgmma"


def test_the_probes_shapes_and_the_port_layout_are_on_the_rule():
    """Every shape the r11 probes and chip_smoke.py's phase (r) drive, both
    layouts of x: the named full-width shapes, their check shapes, the diag
    shape and the (out, in) port layout."""
    port_layout = (768, 4000, 268800)
    for shape in (*r11.SHAPES.values(), *r11.CHECK_SHAPES.values(), r11.DIAG_SHAPE,
                  port_layout):
        for xt in LAYOUTS:
            assert dga.fused_arrangement(*_meta(shape, torch.bfloat16, xt), x_transposed=xt) \
                == "wgmma", (shape, xt)
    assert port_layout in TENSOR_CORE_SHAPES


@pytest.mark.parametrize("shape", K_TAILS, ids=_ids(K_TAILS))
def test_a_k_tail_takes_the_tensor_cores_only_with_x_as_k_by_m(shape):
    assert dga.fused_arrangement(*_meta(shape, torch.bfloat16)) == "wgmma"
    assert dga.fused_arrangement(*_meta(shape, torch.bfloat16, True), x_transposed=True) \
        == "cuda_core"


@pytest.mark.parametrize("shape", TENSOR_CORE_SHAPES[:2], ids=_ids(TENSOR_CORE_SHAPES[:2]))
def test_float32_stays_on_cuda_cores(shape):
    for xt in LAYOUTS:
        ops = _meta(shape, torch.float32, xt)
        assert dga.fused_arrangement(*ops, x_transposed=xt) == "cuda_core", xt


@pytest.mark.parametrize("x_transposed", [False, True], ids=["x_km", "x_mk"])
@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=_ids(RAGGED_SHAPES))
def test_ragged_m_or_n_stays_on_cuda_cores(shape, x_transposed):
    ops = _meta(shape, torch.bfloat16, x_transposed)
    assert dga.fused_arrangement(*ops, x_transposed=x_transposed) == "cuda_core"


def _shifted(t, offset):
    buf = torch.empty(t.numel() + offset, dtype=t.dtype)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("which", NAMES)
def test_an_operand_off_a_16_byte_boundary_stays_on_cuda_cores(which):
    K, M, N = 16, 64, 128
    for xt in LAYOUTS:
        shapes = {"x": (M, K) if xt else (K, M), "dz": (K, N), "w": (M, N), "mu": (M, N),
                  "nu": (M, N)}
        ops = {k: _shifted(torch.zeros(s, dtype=torch.bfloat16), 0) for k, s in shapes.items()}
        assert all(t.data_ptr() % 16 == 0 for t in ops.values())  # fresh allocations
        assert dga.fused_arrangement(*ops.values(), x_transposed=xt) == "wgmma"
        ops[which] = _shifted(ops[which], 1)
        assert dga.fused_arrangement(*ops.values(), x_transposed=xt) == "cuda_core", xt


# K = 64 (2^31 - 1) is the last K whose stages of 64 rows an int counts; 2^16 x (2^15 - 1) tiles
# of 128 x 128 the last grid below 2^31 blocks (meta tensors: no memory)
_LAST_K, _LAST_M, _LAST_N = 64 * (2**31 - 1), 128 * 2**16, 128 * (2**15 - 1)


@pytest.mark.parametrize("shape,arrangement", [
    ((_LAST_K, 8, 8), "wgmma"), ((_LAST_K + 8, 8, 8), "cuda_core"),
    ((64, _LAST_M, _LAST_N), "wgmma"), ((64, _LAST_M, _LAST_N + 128), "cuda_core"),
], ids=["last_k", "k_past_an_int_of_stages", "last_grid", "grid_past_an_int"])
def test_counts_past_the_kernels_int_stay_on_cuda_cores(shape, arrangement):
    """The rule refuses what ``dgaw_launch`` refuses, so the tensor-core kernel
    is never handed operands it would reject."""
    for xt in LAYOUTS:
        ops = _meta(shape, torch.bfloat16, xt)
        assert dga.fused_arrangement(*ops, x_transposed=xt) == arrangement, xt


@pytest.mark.parametrize("shape", [(16, 256, 128), (5, 37, 53)], ids=_ids(
    [(16, 256, 128), (5, 37, 53)]))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("x_transposed", [False, True], ids=["x_km", "x_mk"])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(shape, dtype, x_transposed):
    K, M, N = shape
    rng = np.random.default_rng(K + M + N)

    def normal(s, scale):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32)).to(dtype)

    x, dz = normal((K, M), 0.5), normal((K, N), 1e-3)
    state = [normal((M, N), 0.02), normal((M, N), 1e-4),
             torch.from_numpy((1e-6 * rng.random((M, N))).astype(np.float32)).to(dtype)]
    ref = [t.clone() for t in state]
    before = (dict(dga.launches), dict(dga.fused_arrangements))
    got = dga.fused_dense_grad_adam(x.t().contiguous() if x_transposed else x, dz, *state,
                                    count=3, x_transposed=x_transposed, **ADAM)
    assert (dict(dga.launches), dict(dga.fused_arrangements)) == before
    assert all(a is b for a, b in zip(got, state))
    dga.fused_dense_grad_adam_reference(x, dz, *ref, count=3, **ADAM)
    assert all(torch.equal(a, b) for a, b in zip(state, ref))


def test_the_arrangement_counter_is_separate_from_the_launch_counters():
    """``launches["fused"]`` and ``["fused_xt"]`` keep counting every launch under
    their old keys; the arrangements are counted beside them, not in ``launches``."""
    assert set(dga.fused_arrangements) == {"wgmma", "cuda_core"}
    assert dga.fused_arrangements is not dga.dense_grad_arrangements
    assert "wgmma" not in dga.launches and {"fused", "fused_xt"} <= set(dga.launches)


def test_the_tile_knob_is_gone():
    """One configuration a shape: the tensor cores' 128 x 128 tile on the rule,
    the 64 x 64 CUDA-core tile off it; no ``tile=`` and no ``TILES``."""
    assert not hasattr(dga, "TILES")
    x = torch.zeros((8, 8), dtype=torch.bfloat16)
    state = [torch.zeros((8, 8), dtype=torch.bfloat16) for _ in range(3)]
    with pytest.raises(TypeError, match="tile"):
        dga.fused_dense_grad_adam(x, x.clone(), *state, count=1, tile="big", **ADAM)
    text = CUDA_CORE_SOURCE.read_text()
    assert "big_tile" not in text and ", 8>(" not in text and "int R>\n__global__" not in text
    assert "launch_tile<T, true, true>(" in text and "constexpr int R = 4;" in text


def test_the_source_carries_its_note_and_c_interface():
    """The TPU kernels it replaces, its bound, its registers, and the C names
    that ops/dense_grad_adam.py binds."""
    text = SOURCE.read_text()
    for needle in ("benchmarks/r11_kernel.py:84 _kernel", "benchmarks/r11_diag.py:132 fused_xt",
                   "0.191 ms", "Registers and spills (ptxas -v, sm_90a, CUDA 12.9)",
                   '#include "adam_step.cuh"', '#include "wgmma_bf16.cuh"',
                   'extern "C" int dgaw_launch(', 'extern "C" const char* dgaw_error_string(',
                   "wgmma_bf16::mainloop<kStages, XT>", "cudaErrorInvalidValue"):
        assert needle in text, needle


def test_the_replaced_tpu_kernels_are_where_the_note_says():
    kernel = (REPO / "benchmarks" / "r11_kernel.py").read_text().splitlines()
    assert kernel[83].startswith("def _kernel(") and "pl.pallas_call(" in kernel[208]
    diag = (REPO / "benchmarks" / "r11_diag.py").read_text().splitlines()
    assert 'variant == "fused_xt"' in diag[128]
    assert "def kernel(" in diag[131] and "pl.pallas_call(" in diag[144]


def test_the_mainloop_header_takes_a_k_major_a_beside_its_default():
    """Kernel 5's A is K-major (transpose bit 0, 32-byte k16 steps, SBO 1 KB);
    the default instantiation, kernel 6's and kernel 11's, keeps both bits."""
    text = MAINLOOP.read_text()
    for needle in ("p, 1, 1, 0, 1;", "p, 1, 1, 1, 1;",
                   "template <int STAGES, bool A_K_MAJOR = false>",
                   "make_descriptor(sa + ks * 32, 16, 1024)",
                   "make_descriptor(sa + ks * 2048, kAtomBytes, 1024)"):
        assert needle in text, needle


def test_the_step_lives_in_one_header_that_both_sources_use():
    """Moved, not copied: the header defines each piece of the step, neither
    source does, and the sources name them through the header's namespace."""
    header, cuda_core, tensor_core = (p.read_text() for p in (STEP, CUDA_CORE_SOURCE, SOURCE))
    assert "namespace adam_step {" in header
    for name, definition in (("AdamScalars", "struct AdamScalars {"),
                             ("StepScalars", "struct StepScalars {"),
                             ("adam_f32", "void adam_f32("), ("adam_bf16", "void adam_bf16("),
                             ("load_vec", "void load_vec("), ("store_vec", "void store_vec(")):
        assert header.count(definition) == 1, name
        assert definition not in cuda_core and definition not in tensor_core, name
        if name not in ("adam_f32", "adam_bf16"):
            assert f"adam_step::{name}" in cuda_core or f"adam_step::{name}" in tensor_core


# -- the build digest ---------------------------------------------------------------------------

def test_both_sources_include_the_step_header():
    assert _build.included_headers(CUDA_CORE_SOURCE) == [STEP.resolve()]
    assert _build.included_headers(SOURCE) == sorted([STEP.resolve(), MAINLOOP.resolve()])


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


@pytest.mark.parametrize("edited", ["adam_step.cuh", "wgmma_bf16.cuh"])
def test_an_edit_to_a_header_rebuilds_the_sources_that_include_it(tmp_path, monkeypatch,
                                                                  edited):
    """Copies of the sources and headers in a private csrc: editing the step
    header gives both dense-update sources a new library; editing the mainloop
    header only the tensor-core ones; restoring the header finds the old ones."""
    log = _fake_nvcc(tmp_path, monkeypatch)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    names = ("dense_grad_adam", "dense_grad_adam_wgmma", "dense_grad_wgmma", "moments")
    for f in [*(_build.CSRC / f"{n}.cu" for n in names), STEP, MAINLOOP]:
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)

    def load_all():
        _build._loaded.clear()
        return {n: _build.load_library(n)[1] for n in names}

    first = load_all()
    header = csrc / edited
    original = header.read_bytes()
    header.write_bytes(original + b"// edited\n")
    second = load_all()
    header.write_bytes(original)
    third = load_all()
    rebuilt = {n for n in names if first[n] != second[n]}
    assert rebuilt == ({"dense_grad_adam", "dense_grad_adam_wgmma"} if edited == "adam_step.cuh"
                       else {"dense_grad_adam_wgmma", "dense_grad_wgmma"})
    assert third == first
    assert len(log.read_text().splitlines()) == len(names) + 2  # a restored header: no build
