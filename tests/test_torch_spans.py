"""The port's spans on the profiler's clock (heatmap_tpu_torch/utils/trace.py)
and the benchmark's reader of them (benchmark/spans.py), on the CPU.

While a ``torch.profiler`` records, every ``Tracer.span`` and
``stage_span`` is also a ``record_function`` range of its name (a
``user_annotation`` event); with no profiler running, ``record_function``
is never entered, and with stage tracing off a stage span adds nothing
to the tracer's report or the telemetry.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

from benchmark import spans as bspans
from benchmark import trace as btrace
from heatmap_tpu_torch import bench, obs
from heatmap_tpu_torch.io.sources import SyntheticSource
from heatmap_tpu_torch.obs import events
from heatmap_tpu_torch.ops.histogram import window_from_bounds
from heatmap_tpu_torch.pipeline import batch as tbatch
from heatmap_tpu_torch.streaming import HeatmapStream, StreamConfig
from heatmap_tpu_torch.utils import trace as ttrace

JOB_SPANS = {"ingest.vocab", "ingest.concat", "cascade.project",
             "cascade.emissions", "cascade.decode", "egress.finalize",
             "egress.blobs"}
STEP_SPANS = {"project.rows", "project.recheck", "project.cols",
              "bin.window", "pyramid.coarsen"}
STREAM_SPANS = {"stream.pad", "stream.copy", "stream.decay"}


@pytest.fixture(autouse=True)
def _reset():
    yield
    ttrace.enable_stage_tracing(False)
    ttrace.get_tracer().reset()
    obs.enable_metrics(False)
    obs.get_registry().reset()
    log = events.get_event_log()
    if log is not None:
        log.close()
        events.set_event_log(None)


def _job():
    return tbatch.run_job(SyntheticSource(n=3000, seed=4), device="cpu",
                          max_points_in_flight=0)


def _step():
    window = window_from_bounds((47.0, 48.2), (-123.0, -121.6), 11,
                                align_levels=3, pad_multiple=8)
    lat, lon = bench.make_points(4000, seed=3)
    _, pyr = bench.step(torch.as_tensor(lat, dtype=torch.float64),
                        torch.as_tensor(lon, dtype=torch.float64), window,
                        3, "auto", proj_dtype=torch.float64)
    return [lvl.numpy().copy() for lvl in pyr]


def _stream():
    window = window_from_bounds((47.0, 48.2), (-123.0, -121.6), 10,
                                align_levels=2, pad_multiple=8)
    s = HeatmapStream(StreamConfig(window=window, pad_to=1024), device="cpu")
    lat, lon = bench.make_points(1000, seed=5)
    s.update(lat, lon, 0.0).update(lat, lon, 5.0)
    return s.snapshot()


def _annotations(fn, tmp_path):
    """``(fn(), names of the user_annotation events)`` of one profiled
    call of ``fn`` on the CPU."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    return out, {e["name"] for e in evs if e.get("cat") == "user_annotation"}


def _report_layout():
    return {name: (r["count"], r["items"])
            for name, r in ttrace.get_tracer().report().items()}


# ---- (a) no profiler: record_function is never entered -------------------

@pytest.mark.parametrize("stage_tracing", [False, True],
                         ids=["stage-off", "stage-on"])
def test_no_profiler_never_enters_record_function(monkeypatch,
                                                  stage_tracing):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    ttrace.enable_stage_tracing(stage_tracing)
    tracer = ttrace.get_tracer()
    tracer.reset()
    with tracer.span("outer", items=3):
        with ttrace.stage_span("inner", items=2):
            pass
    with ttrace.Tracer().span("own"):
        pass
    want = {"outer": (1, 3)}
    if stage_tracing:
        want["inner"] = (1, 2)
    assert _report_layout() == want
    _step()
    _job()


def test_profiler_leaves_report_and_telemetry_alone(tmp_path):
    """A job under the profiler, stage tracing off, gives the tracer
    report, the stage metrics and the ``stage_end`` events of a job
    without it: the stage spans open only the profiler's range."""
    obs.enable_metrics(True)
    got = []
    for profiled in (False, True):
        ttrace.get_tracer().reset()
        obs.get_registry().reset()
        log_path = tmp_path / f"events-{profiled}.jsonl"
        events.set_event_log(events.EventLog(str(log_path)))
        run = (lambda fn: _annotations(fn, tmp_path)[0]) if profiled else (
            lambda fn: fn())
        run(_job)
        run(_step)
        events.get_event_log().close()
        events.set_event_log(None)
        stage_ends = sorted(r["stage"] for r in events.read_events(
            str(log_path)) if r["event"] == "stage_end")
        stage_counts = {k: v[2] for k, v in obs.STAGE_SECONDS.samples().items()}
        got.append((_report_layout(), stage_counts, stage_ends))
    assert got[0] == got[1]
    assert not (STEP_SPANS | {"ingest.vocab", "ingest.concat"}) & set(got[0][0])


# ---- (b) the spans on the profiler's timeline ------------------------------

def test_job_spans_are_profiler_annotations(tmp_path):
    _, names = _annotations(_job, tmp_path)
    assert JOB_SPANS <= names


def test_step_spans_are_profiler_annotations(tmp_path):
    _, names = _annotations(_step, tmp_path)
    assert STEP_SPANS <= names


def test_stream_spans_are_profiler_annotations(tmp_path):
    _, names = _annotations(_stream, tmp_path)
    assert STREAM_SPANS <= names


def test_stage_tracing_records_the_new_spans():
    ttrace.enable_stage_tracing(True)
    ttrace.get_tracer().reset()
    _step()
    _job()
    _stream()
    report = ttrace.get_tracer().report()
    assert (STEP_SPANS | STREAM_SPANS | {"ingest.vocab", "ingest.concat"}
            ) <= set(report)
    assert report["project.recheck"]["items"] >= 0
    assert report["stream.pad"]["items"] == 2 * (1024 - 1000)


DATED = ("alltime", "year", "month", "day")


def _dated_job():
    return tbatch.run_job(SyntheticSource(n=3000, seed=4), device="cpu",
                          max_points_in_flight=0,
                          config=tbatch.BatchJobConfig(timespans=DATED))


def test_dated_job_spans_are_profiler_annotations(tmp_path):
    _, names = _annotations(_dated_job, tmp_path)
    assert {"emissions.timespans", "egress.slot_names"} <= names


def test_dated_job_span_items_and_counters():
    """Under stage tracing ``emissions.timespans`` counts rows times
    timespan types and ``egress.slot_names`` the slots; the counters
    keep the job's slots and its key width (the z21 code's 42 bits and
    the slots')."""
    from heatmap_tpu_torch.pipeline import cascade as tcascade

    ttrace.enable_stage_tracing(True)
    ttrace.get_tracer().reset()
    assert _dated_job()
    report = ttrace.get_tracer().report()
    rows = report["cascade.project"]["items"]
    assert report["emissions.timespans"]["count"] == 1
    assert report["emissions.timespans"]["items"] == rows * len(DATED)
    n_slots = tcascade.build_cascade.n_slots
    assert n_slots >= len(DATED)
    assert report["egress.slot_names"]["items"] == n_slots
    assert tcascade.build_cascade.key_bits == 42 + (n_slots - 1).bit_length()


def test_dated_job_stage_events_validate(tmp_path):
    """A dated job under stage tracing with an event log installed
    completes, and the ``stage_end`` events of its timespan and
    slot-name spans carry only the schema's fields."""
    ttrace.enable_stage_tracing(True)
    log_path = tmp_path / "events.jsonl"
    events.set_event_log(events.EventLog(str(log_path)))
    assert _dated_job()
    events.get_event_log().close()
    events.set_event_log(None)
    ends = [r for r in events.read_events(str(log_path))
            if r["event"] == "stage_end"
            and r["stage"] in ("emissions.timespans", "egress.slot_names")]
    assert sorted(r["stage"] for r in ends) == ["egress.slot_names",
                                                "emissions.timespans"]
    for rec in ends:
        events.validate_event(rec)


def _blob_counters(monkeypatch):
    from heatmap_tpu_torch.pipeline import cascade as tcascade

    f = tcascade.json_blobs_from_level_arrays
    monkeypatch.setattr(f, "dict_blobs", 0)
    monkeypatch.setattr(f, "numpy_blobs", 0)
    return f


def test_count_job_blobs_come_from_the_dict_builder(monkeypatch):
    f = _blob_counters(monkeypatch)
    blobs = _job()
    assert f.dict_blobs == len(blobs) > 0
    assert f.numpy_blobs == 0


def test_fractional_weighted_job_blobs_come_from_numpy(monkeypatch):
    f = _blob_counters(monkeypatch)
    rows = list(SyntheticSource(n=1500, seed=3).rows())
    fractions = np.random.default_rng(3).random(len(rows)) * 10
    for r, v in zip(rows, fractions):
        r["value"] = float(v)
    blobs = tbatch.run_batch(rows, tbatch.BatchJobConfig(weighted=True),
                             as_json=True, device="cpu")
    assert f.numpy_blobs == len(blobs) > 0
    assert f.dict_blobs == 0


def test_egress_blobs_span_carries_items_and_path(tmp_path):
    """``egress.blobs`` counts the job's blobs in the tracer's report,
    and the ``backend`` of its ``stage_end`` event names the path that
    made them."""
    ttrace.get_tracer().reset()
    log_path = tmp_path / "events.jsonl"
    events.set_event_log(events.EventLog(str(log_path)))
    blobs = _job()
    events.get_event_log().close()
    events.set_event_log(None)
    assert ttrace.get_tracer().report()["egress.blobs"]["items"] == len(
        blobs) > 0
    ends = [r for r in events.read_events(str(log_path))
            if r["event"] == "stage_end" and r["stage"] == "egress.blobs"]
    assert [r["backend"] for r in ends] == ["dict"]


# ---- (c) the same answers with the profiler on and off ---------------------

def test_profiler_changes_no_answer(tmp_path):
    blobs, profiled_blobs = _job(), _annotations(_job, tmp_path)[0]
    assert blobs and blobs == profiled_blobs
    pyr, profiled_pyr = _step(), _annotations(_step, tmp_path)[0]
    assert len(pyr) == len(profiled_pyr) == 4
    for a, b in zip(pyr, profiled_pyr):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_stream(),
                                  _annotations(_stream, tmp_path)[0])


# ---- (d) benchmark/spans.py ------------------------------------------------

def _synthetic_events(spans: bool = True):
    """A window of 1000 us holding one ``project.rows`` span (100-300
    us) with a kernel and a copy launched inside it and a kernel
    launched outside, and a ``cascade.decode`` span opened twice;
    ``spans=False`` leaves the spans out."""
    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "tid": 1, "args": args}

    evs = [
        x(btrace.WINDOW, "user_annotation", 0, 1000),
        x("project.rows", "user_annotation", 100, 200),
        x("cudaLaunchKernel", "cuda_runtime", 150, 5, correlation=7),
        x("elementwise_kernel", "kernel", 160, 40, correlation=7, device=0),
        x("cudaMemcpyAsync", "cuda_runtime", 290, 5, correlation=8),
        x("Memcpy HtoD", "gpu_memcpy", 300, 30, correlation=8, device=0),
        x("aten::sum", "cpu_op", 395, 20),
        x("cudaLaunchKernel", "cuda_runtime", 400, 5, correlation=9),
        x("reduce_kernel", "kernel", 410, 60, correlation=9, device=0),
        x("cascade.decode", "user_annotation", 500, 100),
        x("cascade.decode", "user_annotation", 700, 350),
    ]
    return [e for e in evs if spans or e["name"] == btrace.WINDOW
            or e["cat"] != "user_annotation"]


def _synthetic_trace():
    return btrace.Trace(_synthetic_events())


def test_spans_device_ms_counts_work_launched_inside_the_span():
    tr = _synthetic_trace()
    # The kernel and the copy launched at 150 and 290 us count (70 us);
    # the kernel launched at 400 us, outside the span, does not.
    assert bspans.device_ms(tr, "project.rows", 2) == pytest.approx(0.035)
    assert bspans.device_ms(tr, "cascade.decode", 1) == 0.0
    assert bspans.device_ms(tr, "egress.blobs", 1) is None
    assert bspans.device_ms(None, "project.rows", 1) is None


def test_spans_host_ms_sums_the_span_inside_the_window():
    tr = _synthetic_trace()
    # 100 us, then 300 of the second interval's 350 inside the window.
    assert bspans.host_ms(tr, "cascade.decode", 2) == pytest.approx(0.2)
    assert bspans.host_ms(tr, "project.rows", 1) == pytest.approx(0.2)
    assert bspans.host_ms(tr, "egress.blobs", 1) is None
    assert bspans.host_ms(None, "cascade.decode", 1) is None


def test_span_ranges_stay_out_of_busy_time_and_op_time():
    with_spans = btrace.Trace(_synthetic_events())
    without = btrace.Trace(_synthetic_events(spans=False))
    assert with_spans.busy_s() == without.busy_s() == pytest.approx(130e-6)
    names = {"elementwise_kernel"}
    assert with_spans.op_time(names) == without.op_time(names) == (
        pytest.approx(70e-6), 1)
    assert with_spans.device_ops() == without.device_ops()


def test_spans_read_a_profiled_job(tmp_path):
    sink = {}
    with btrace.profiled(torch.device("cpu"), sink):
        _job()
    tr = sink["trace"]
    for name in JOB_SPANS:
        assert bspans.host_ms(tr, name, 1) > 0, name


# ---- cascade.device times execution under stage tracing --------------------

def test_cascade_device_span_closes_after_the_card_finishes(monkeypatch):
    """Under stage tracing the card is synchronised inside
    ``cascade.device``, after its work, not only in the spans it
    encloses."""
    open_spans, synced_in = [], []
    real_span = ttrace.Tracer.span

    @contextlib.contextmanager
    def span(self, name, items=None, **attrs):
        open_spans.append(name)
        try:
            with real_span(self, name, items=items, **attrs) as span_attrs:
                yield span_attrs
        finally:
            open_spans.pop()

    monkeypatch.setattr(ttrace.Tracer, "span", span)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced_in.append(
                            open_spans[-1] if open_spans else None))
    ttrace.enable_stage_tracing(True)
    tbatch.run_job(SyntheticSource(n=2000, seed=1), device="cpu",
                   max_points_in_flight=0)
    assert "cascade.device" in synced_in
    assert synced_in.index("cascade.device") > synced_in.index(
        "cascade.segment-reduce")
