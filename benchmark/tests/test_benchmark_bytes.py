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


def test_project_mercator_bytes():
    # Latitude and longitude (float64) read once; row, column (int32)
    # and validity (1 byte) written once: 25 bytes a lane, 621,924,450 B
    # for the bulk step's 24,876,978 points (185.6 us at 3.35 TB/s).
    assert roofline.project_mercator_bytes(1) == 25
    assert roofline.project_mercator_bytes(24_876_978) == 621_924_450


def test_dense_pyramid_bytes():
    # A 4 x 4 int32 raster read once, its 2 x 2 and 1 x 1 levels
    # written once.
    assert roofline.dense_pyramid_bytes(4, 4, 2) == 4 * (16 + 4 + 1)
    assert roofline.dense_pyramid_bytes(4, 4, 0) == 4 * 16
    # The bulk window: 8192 x 4096 cells and 10 levels, 178,956,928 B
    # (53.4 us at 3.35 TB/s).
    assert roofline.dense_pyramid_bytes(4096, 8192, 10) == 178_956_928


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
    assert roofline.kernel_names("dense_pyramid") == {"pyramid_kernel"}
    assert roofline.kernel_names("project_mercator") == {"project_kernel"}


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


def _rt(name, ts, corr):
    return {"ph": "X", "name": name, "cat": "cuda_runtime", "ts": ts,
            "dur": 1, "tid": 1, "args": {"correlation": corr}}


def _dev(name, cat, ts, dur, corr):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": {"device": 0, "correlation": corr}}


def _span(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "user_annotation", "ts": ts,
            "dur": dur, "tid": 1, "args": {}}


def test_op_time_counts_a_c_launch_run_with_its_memsets():
    rt, dev = _rt, _dev
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


def _two_spans_events():
    """Binning's C call (a memset and two kernels) under ``bin.window``,
    then the pyramid's C call (two launches) under ``pyramid.coarsen``,
    with no operator between them, as a bulk step makes them; then an
    operator and its kernel."""
    return [
        _x(trace.WINDOW, "user_annotation", 0, 1000),
        _span("bin.window", 10, 50),
        _rt("cudaMemsetAsync", 12, 1),
        _rt("cudaLaunchKernel", 14, 2),
        _rt("cudaLaunchKernel", 16, 3),
        _span("pyramid.coarsen", 70, 20),
        _rt("cudaLaunchKernel", 72, 4),
        _rt("cudaLaunchKernel", 74, 5),
        {"ph": "X", "name": "aten::sum", "cat": "cpu_op", "ts": 95,
         "dur": 10, "tid": 1, "args": {}},
        _rt("cudaLaunchKernel", 97, 6),
        _dev("Memset (Device)", "gpu_memset", 100, 3, 1),
        _dev("(anonymous namespace)::count_kernel(int)", "kernel", 105, 40,
             2),
        _dev("(anonymous namespace)::bin_kernel(int)", "kernel", 150, 60, 3),
        _dev("void (anonymous namespace)::pyramid_kernel<int, true>(int)",
             "kernel", 215, 30, 4),
        _dev("void (anonymous namespace)::pyramid_kernel<int, false>(int)",
             "kernel", 250, 5, 5),
        _dev("at::native::reduce_kernel", "kernel", 260, 2, 6),
    ]


def test_op_time_ends_a_call_where_the_span_changes():
    """Two C calls under two spans, with no operator between them, are
    two calls: binning's time leaves out the pyramid's, and the
    pyramid's leaves out binning's."""
    tr = trace.Trace(_two_spans_events())
    s, calls = tr.op_time({"count_kernel", "bin_kernel"})
    assert calls == 1
    assert s == pytest.approx((3 + 40 + 60) * 1e-6)
    assert tr.op_calls({"pyramid_kernel"}) == [(pytest.approx(35e-6), 2)]
    # Without the spans the two C calls run together, as before.
    bare = trace.Trace([e for e in _two_spans_events()
                        if e["name"] not in ("bin.window", "pyramid.coarsen")])
    assert bare.op_calls({"pyramid_kernel"}) == [(pytest.approx(138e-6), 2)]


class _Ctx:
    def __init__(self, tr, counters):
        self.trace, self.counters = tr, counters


@pytest.mark.parametrize("launches, units, share", [
    (2, 1, 100.0 * 1000 / roofline.HBM_BYTES_PER_S / 35e-6),
    (3, 1, None),  # the program counted a launch the trace lacks
    (2, 2, None),  # a unit whose call the trace lacks
    (0, 1, None),  # nothing launched
])
def test_traced_share_holds_calls_to_the_counts(launches, units, share):
    ctx = _Ctx(trace.Trace(_two_spans_events()),
               {"traced_counters": {"pyramid_launches": launches},
                "units": units})
    got = roofline.traced_share(ctx, "dense_pyramid", "pyramid_launches",
                                1000)
    assert got == (None if share is None else pytest.approx(share))
