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
