"""The frozen ``analyze_trace`` and the ``Trace`` reader on hand-made Chrome traces."""

import pytest

from perfbench.yardstick.trace import ATEN_CONV, Trace, analyze_trace, short_name


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _events():
    # host: one window range 0..100 on thread 1; two steps; a convolution op on thread 1
    # and a backward convolution on thread 2; launches joined to kernels by correlation
    return [
        _x("pb.window", "user_annotation", 0, 100),
        _x("pb.step", "user_annotation", 0, 50),
        _x("pb.step", "user_annotation", 50, 50),
        _x("aten::convolution", "cpu_op", 5, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 6, 1, correlation=1),
        _x("aten::add", "cpu_op", 20, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 21, 1, correlation=2),
        _x("aten::convolution_backward", "cpu_op", 60, 10, tid=2),
        _x("cuLaunchKernel", "cuda_driver", 61, 1, tid=2, correlation=3),
        _x("pb.optimizer", "user_annotation", 80, 10),
        _x("cudaMemcpyAsync", "cuda_runtime", 81, 1, correlation=4),
        # device: kernels 10..30, 40..50, 70..75, a copy 85..95; idle 0..10, 30..40,
        # 50..70, 75..85, 95..100
        _x("void cudnn::conv_kernel<float>(int)", "kernel", 10, 20, tid=7, correlation=1),
        _x("at::native::add_kernel(float)", "kernel", 40, 10, tid=7, correlation=2),
        _x("void dgrad_engine<float>()", "kernel", 70, 5, tid=7, correlation=3),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 85, 10, tid=7, correlation=4),
    ]


def test_short_name_drops_types_and_arguments():
    assert short_name("void cudnn::conv_kernel<float>(int)") == "cudnn::conv_kernel"
    assert short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_analyze_trace_busy_share():
    a = analyze_trace(_events(), 2, "pb.window")
    assert a["window_ms_per_frame"] == pytest.approx(0.05)
    assert a["device_busy_ms_per_frame"] == pytest.approx(0.0225)   # 45 us of 100, per 2
    assert a["busy_share"] == pytest.approx(0.45)
    assert a["idle_share"] == pytest.approx(0.55)
    assert a["kernels"][0]["kernel"] == "cudnn::conv_kernel"


def test_trace_attributes_launches_to_ranges():
    t = Trace(_events(), 2, "pb.window")
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6)
    conv = t.launched_in(ATEN_CONV)
    assert sorted(e["name"] for e in conv) == [
        "void cudnn::conv_kernel<float>(int)", "void dgrad_engine<float>()"]
    assert t.ms_per_step(conv) == pytest.approx(0.0125)
    assert [e["name"] for e in t.launched_in(["pb.optimizer"])] == [
        "Memcpy HtoD (Pageable -> Device)"]
    assert t.ms_per_step(t.copies("HtoD")) == pytest.approx(0.005)
    assert t.launched_in(["pb.nothing"]) == []


def test_idle_gaps_are_labelled_by_the_host_range():
    t = Trace(_events(), 2, "pb.window")
    gaps = t.idle_gaps("pb.")
    assert gaps[0] == ["pb.step", pytest.approx(20e-6)]  # 50..70, in the second step
    assert sorted(g[1] for g in gaps) == pytest.approx([5e-6, 10e-6, 10e-6, 10e-6, 20e-6])
    assert ["pb.optimizer", pytest.approx(10e-6)] in gaps  # 75..85: the host in the optimizer
    assert t.top_device_ops(1) == [["cudnn::conv_kernel", pytest.approx(10e-6)]]
