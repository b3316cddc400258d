"""The trace arithmetic of profile_stream_torch.py on a hand-made trace."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_stream_torch import analyze_trace, short_name  # noqa: E402


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_share_is_the_union_of_device_intervals_in_the_frames():
    events = [
        _x("frame", "user_annotation", 100.0, 100.0),
        _x("frame", "user_annotation", 200.0, 100.0),
        _x("void gemv2T_kernel_val<int, float>(float const*)", "kernel", 110.0, 40.0),
        _x("void gemv2T_kernel_val<int, float>(float const*)", "kernel", 210.0, 40.0),
        _x("stream_score_kernel", "kernel", 140.0, 20.0),  # overlaps the first gemv
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 280.0, 40.0),  # past the end
        _x("before", "kernel", 0.0, 50.0),  # outside the window
        _x("aten::linear", "cpu_op", 110.0, 5.0),
    ]
    out = analyze_trace(events, n_frames=2)
    assert out["window_ms_per_frame"] == pytest.approx(0.1)
    # gemv 110-150 and the scorer 140-160 overlap: 50 us; gemv 210-250: 40 us;
    # the copy counts from 280 to the window's end at 300: 20 us
    assert out["device_busy_ms_per_frame"] == pytest.approx(0.110 / 2)
    assert out["busy_share"] == pytest.approx(0.55)
    assert out["idle_share"] == pytest.approx(0.45)
    assert out["device_sum_ms_per_frame"] == pytest.approx((40 + 40 + 20 + 40) / 1e3 / 2)
    assert [r["kernel"] for r in out["kernels"]] == [
        "gemv2T_kernel_val", "Memcpy HtoD", "stream_score_kernel"]
    assert out["kernels"][0]["launches_per_frame"] == 1.0


def test_trace_without_frames_is_refused():
    with pytest.raises(ValueError, match="no 'frame' annotations"):
        analyze_trace([_x("k", "kernel", 0.0, 1.0)], n_frames=1)


@pytest.mark.parametrize("name,short", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)",
     "at::native::vectorized_elementwise_kernel"),
    ("(anonymous namespace)::stream_score_kernel(float const*, float*, int, int)",
     "stream_score_kernel"),
    ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, float, 9>(float)",
     "internal::gemvx::kernel"),
    ("void gemv2T_kernel_val<int, int, float, 128>(cublasGemvParamsEx<int>)", "gemv2T_kernel_val"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_execute_kernel__5x_cudnn",
     "sm80_xmma_fprop_implicit_gemm_f32f32_execute_kernel__5x_cudnn"),
    ("void at::native::(anonymous namespace)::upsample_gen2d_aa_out_frame<float>(float)",
     "at::native::upsample_gen2d_aa_out_frame"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH"),
])
def test_short_name(name, short):
    assert short_name(name) == short


def test_kernel_bounds_follow_from_the_shapes():
    """kernel_bounds_torch.py: each bound is the larger of bytes over 3.35 TB/s
    and operations over the peak of their type, at the probes' shapes."""
    import kernel_bounds_torch as kb

    table = kb.bounds()
    assert sorted({r["row"] for r in table}) == list(range(1, 12))
    by_kernel = {r["kernel"]: r for r in table}
    frame = by_kernel["ops/stream_score.py:98 _stream_kernel"]
    assert frame["bytes"] == 4 * (2 * 67200 * 3 + 4 * 67200 + 12 + 67200 + 2)
    assert frame["bound_by"] == "bytes"
    fwd = by_kernel["ops/moments.py:98 _perdim_kernel forward"]
    assert fwd["bytes"] == 2_048_000 + 32_000 and fwd["bound_by"] == "bytes"
    assert abs(fwd["bound_ms"] - 2_080_000 / 3.35e12 * 1e3) < 1e-12
    dot = by_kernel["r11_diag.py:163 dot_only"]
    assert dot["bound_by"] == "operations"
    assert abs(dot["bound_ms"] - 2 * 768 * 12800 * 4000 / 989e12 * 1e3) < 1e-12
    for r in table:
        assert r["bound_ms"] == max(r["bytes_ms"], r["operations_ms"]) > 0
    assert kb.main(["--json"]) == 0


def test_kernel_bounds_of_the_int8_gemm_at_the_probe_and_the_serving_shapes():
    """Row 10 at the probe's shape, at the two quantized Dense layers of the
    serving path for 1 and 16 frames and of the offline path for a batch of
    256: all bound by the bytes."""
    import kernel_bounds_torch as kb

    rows = [r for r in kb.bounds() if r["row"] == 10]
    assert [r["shapes"] for r in rows] == [
        "M=32 K=268800 N=4096 int8 -> int32", "M=16 K=268800 N=4000", "M=1 K=268800 N=4000",
        "M=16 K=2000 N=134400", "M=1 K=2000 N=134400", "M=256 K=268800 N=4000",
        "M=256 K=2000 N=134400"]
    assert rows[0]["bytes"] == 32 * 268800 + 268800 * 4096 + 4 * 32 * 4096
    assert abs(rows[0]["bound_ms"] - 0.33138) < 1e-5
    assert rows[1]["bytes"] == 16 * 268800 + 268800 * 4000 + 4 * 16 * 4000
    assert rows[4]["bytes"] == 2000 + 2000 * 134400 + 4 * 134400
    assert rows[5]["bytes"] == 256 * 268800 + 268800 * 4000 + 4 * 256 * 4000
    assert rows[6]["bytes"] == 256 * 2000 + 2000 * 134400 + 4 * 256 * 134400
    assert abs(rows[5]["bound_ms"] - 0.34272) < 1e-5 and abs(rows[6]["bound_ms"] - 0.12147) < 1e-5
    assert all(r["bound_by"] == "bytes" for r in rows)
