"""The least-bytes arithmetic, the kernels' names and the trace reader."""

from __future__ import annotations

import pytest

from benchmark import roofline, trace


def test_window_bucketed_bytes():
    # 2^25 points: row, col (int32) and valid (1 byte) once each; a
    # 4096 x 4096 int32 raster written once.
    assert roofline.window_bucketed_bytes(1 << 25, 4096 * 4096) == \
        (1 << 25) * 9 + 4 * 4096 * 4096
    assert roofline.window_bucketed_bytes(0, 16) == 64


def test_segment_reduce_bytes():
    # Keys (int64) read once; unique keys (int64) and counts (int32)
    # written once, and the unique count.
    assert roofline.segment_reduce_bytes(1000, 10) == 8000 + 120 + 4


def test_share_pct():
    # 3.35 GB moved in 1 ms is the whole HBM bandwidth.
    assert roofline.share_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert roofline.share_pct(3.35e9, 2e-3) == pytest.approx(50.0)
    assert roofline.share_pct(1.0, 0.0) is None


def test_kernel_names_from_the_sources():
    assert roofline.kernel_names("window_bucketed") == {
        "count_kernel", "scan_kernel", "scatter_kernel", "bin_kernel"}
    assert roofline.kernel_names("segment_reduce") == {
        "segment_kernel", "pad_kernel"}


def test_short_name():
    assert trace.short_name(
        "void (anonymous namespace)::count_kernel(int const*, bool)") == \
        "count_kernel"
    assert trace.short_name(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<int>, at::detail::Array<char*, 1> >(int, "
        "at::native::FillFunctor<int>)") == \
        "at::native::vectorized_elementwise_kernel"


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def test_trace_busy_idle_and_kernels():
    events = [
        _x(trace.WINDOW, "user_annotation", 0, 100),
        _x("aten::copy_", "cpu_op", 5, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 40, 5),
        _x("(anonymous namespace)::count_kernel(int)", "kernel", 10, 20,
           device=0),
        _x("(anonymous namespace)::bin_kernel(int)", "kernel", 25, 15,
           device=0),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 60, 10,
           device=0),
        _x("other", "kernel", 200, 10, device=0),  # outside the window
    ]
    tr = trace.Trace(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(40e-6)  # [10, 40] and [60, 70]
    assert tr.copy_time("HtoD") == pytest.approx(10e-6)
    gaps = dict(tr.idle_gaps())
    # [0, 10] under aten::copy_ (open 5-35), [40, 60] at 50 (nothing
    # open: the launch ended at 45), [70, 100].
    assert gaps["aten::copy_"] == pytest.approx(10e-6)
    assert gaps["host"] == pytest.approx(50e-6)
    ops = dict(tr.device_ops())
    assert ops["count_kernel"] == pytest.approx(20e-6)


def test_op_time_counts_a_c_launch_run_with_its_memsets():
    def rt(name, ts, corr):
        return {"ph": "X", "name": name, "cat": "cuda_runtime", "ts": ts,
                "dur": 1, "tid": 1, "args": {"correlation": corr}}

    def dev(name, cat, ts, dur, corr):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "args": {"device": 0, "correlation": corr}}

    events = [
        _x(trace.WINDOW, "user_annotation", 0, 1000),
        # A PyTorch operator's launch: enclosed, not part of any C call.
        {"ph": "X", "name": "aten::mul", "cat": "cpu_op", "ts": 10,
         "dur": 10, "tid": 1, "args": {}},
        rt("cudaLaunchKernel", 12, 1),
        dev("at::native::mul_kernel", "kernel", 30, 5, 1),
        # A C call: memset, then two kernels.
        rt("cudaMemsetAsync", 40, 2),
        rt("cudaLaunchKernel", 42, 3),
        rt("cudaLaunchKernel", 44, 4),
        dev("Memset (Device)", "gpu_memset", 50, 7, 2),
        dev("(anonymous namespace)::count_kernel(int)", "kernel", 60, 10, 3),
        dev("(anonymous namespace)::bin_kernel(int)", "kernel", 70, 20, 4),
        # Another operator, then a second C call.
        {"ph": "X", "name": "aten::add", "cat": "cpu_op", "ts": 100,
         "dur": 10, "tid": 1, "args": {}},
        rt("cudaLaunchKernel", 105, 5),
        dev("at::native::add_kernel", "kernel", 120, 5, 5),
        rt("cudaLaunchKernel", 130, 6),
        dev("(anonymous namespace)::count_kernel(int)", "kernel", 140, 10, 6),
    ]
    tr = trace.Trace(events)
    s, calls = tr.op_time({"count_kernel", "bin_kernel"})
    assert calls == 2
    assert s == pytest.approx((7 + 10 + 20 + 10) * 1e-6)
