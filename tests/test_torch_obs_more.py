"""The rest of the port's obs/ (recorder, timeseries, slo, incident,
anomaly) on the CPU against the JAX package's modules: each scenario runs
the same calls, on the same seeded inputs and injected clocks, through
both packages and compares what comes out (ring contents and bounds,
promotion and dedup; tier roll-ups, queries and the atomic spill; burn
rates and breach edges; bundle contents, rate limit and age-wins
pruning; anomaly rising and clearing edges). Also the banned-clock grep
over the port's obs/ and ingest loop, and ``run``'s blobs with the six
telemetry flags on and off."""

import json
import os
import re
import types

import numpy as np
import pytest

from heatmap_tpu import obs as jobs
from heatmap_tpu.obs import anomaly as janomaly
from heatmap_tpu.obs import events as jevents
from heatmap_tpu.obs import incident as jincident
from heatmap_tpu.obs import recorder as jrecorder
from heatmap_tpu.obs import slo as jslo
from heatmap_tpu.obs import timeseries as jtimeseries
from heatmap_tpu.obs import tracing as jtracing
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import obs
from heatmap_tpu_torch.obs import anomaly, events, incident, recorder, slo
from heatmap_tpu_torch.obs import timeseries, tracing
from heatmap_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "torch": types.SimpleNamespace(
        obs=obs, recorder=recorder, tracing=tracing, events=events,
        slo=slo, incident=incident, timeseries=timeseries,
        anomaly=anomaly),
    "jax": types.SimpleNamespace(
        obs=jobs, recorder=jrecorder, tracing=jtracing, events=jevents,
        slo=jslo, incident=jincident, timeseries=jtimeseries,
        anomaly=janomaly),
}


def _reset(p):
    p.obs.enable_metrics(False)
    p.obs.get_registry().reset()
    log = p.obs.get_event_log()
    if log is not None:
        log.close()
        p.obs.set_event_log(None)
    p.tracing.disable_tracing()
    p.slo.set_engine(None)
    p.incident.set_manager(None)
    p.timeseries.shutdown()
    p.anomaly.set_engine(None)
    p.recorder.install(None)
    p.events._observer = None


@pytest.fixture(autouse=True)
def _reset_both():
    for p in PKGS.values():
        _reset(p)
    yield
    for p in PKGS.values():
        _reset(p)
    trace.get_tracer().reset()


def _both(fn, *args):
    """``fn(package namespace, *args)`` for each package, state reset
    in between: {"torch": ..., "jax": ...}."""
    out = {}
    for name, p in PKGS.items():
        _reset(p)
        out[name] = fn(p, *args)
        _reset(p)
    return out


def _fake_clock(start=1000.0):
    state = [start]

    def clock():
        return state[0]

    clock.advance = lambda s: state.__setitem__(0, state[0] + s)
    return clock


def _strip_ids(recs):
    """Span records without their random identities and wall times."""
    drop = ("trace_id", "span_id", "parent_id", "start_s", "dur_s",
            "thread")
    return [{k: v for k, v in r.items() if k not in drop} for r in recs]


# -- flight recorder ---------------------------------------------------------


@pytest.mark.parametrize("max_events,n", [(8, 20), (16, 5), (1, 3)])
def test_event_ring_bounds_equal_jax(max_events, n):
    def run(p):
        rec = p.recorder.FlightRecorder(max_events=max_events)
        p.recorder.install(rec)
        for i in range(n):
            rec.record_event({"event": ("http_request", "ingest_tick")[i % 2],
                              "ts": float(i), "seq": i, "status": 200})
        return rec.event_records(), rec.stats()

    got = _both(run)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("max_spans,names", [
    (4, ("storm.op", "storm.child") * 6),
    (3, ("ingest.tick", "delta.apply", "delta.read", "ingest.tick")),
    (64, ("serve.request",)),
])
def test_span_ring_bounds_equal_jax(max_spans, names):
    def run(p):
        p.obs.enable_metrics(True)
        p.tracing.enable_tracing(sample=0.0)
        rec = p.recorder.FlightRecorder(max_spans=max_spans)
        p.recorder.install(rec)
        for name in names:
            p.tracing.end_span(p.tracing.begin_span(name))
        return (_strip_ids(rec.span_records()), rec.stats(),
                p.obs.RECORDER_DROPPED.value())

    got = _both(run)
    assert got["torch"] == got["jax"]


def _promotion(p, case):
    """One tail-promotion case; returns (promote results, collected span
    names, recorder stats)."""
    sample = 1.0 if case == "sampled_dedup" else 0.0
    collector = p.tracing.enable_tracing(sample=sample)
    rec = p.recorder.FlightRecorder(
        max_spans=64, tail_latency_s=0.05 if case.startswith("tail") else None)
    p.recorder.install(rec)
    root = p.tracing.begin_span("serve.request")
    child = p.tracing.begin_span("tile.render")
    p.tracing.end_span(child)
    results = []
    if case == "error_status":
        results.append(p.recorder.maybe_promote(root, status=503))
    elif case == "error_flag":
        results.append(p.recorder.maybe_promote(root, error=True))
    elif case == "tail_slow":
        results.append(p.recorder.maybe_promote(root, ms=10.0))
        results.append(p.recorder.maybe_promote(root, ms=80.0))
    elif case == "tail_fast":
        results.append(p.recorder.maybe_promote(root, status=200, ms=1.0))
    elif case == "sampled_dedup":
        results.append(p.recorder.maybe_promote(root, status=503))
    elif case == "fault_event":
        p.obs.enable_metrics(True)
        p.obs.record_fault("ingest.tick", 0, key=0)
    p.tracing.end_span(root)
    if case == "sampled_dedup":
        results.append(rec.promote(root.trace_id))
    results.append(p.recorder.maybe_promote(None, error=True))
    return (results, sorted(r["name"] for r in collector.spans()),
            rec.stats())


@pytest.mark.parametrize("case", ["error_status", "error_flag",
                                  "tail_slow", "tail_fast",
                                  "sampled_dedup", "fault_event"])
def test_promotion_and_dedup_equal_jax(case):
    got = _both(_promotion, case)
    assert got["torch"] == got["jax"]


def test_recorder_refusals_and_hooks_equal_jax():
    for p in PKGS.values():
        with pytest.raises(ValueError, match="positive"):
            p.recorder.FlightRecorder(max_spans=0)
        assert p.recorder.maybe_promote(error=True) is False
        p.recorder.install(p.recorder.FlightRecorder())
        assert p.tracing._recorder is p.recorder.get_recorder()
        assert p.events._recorder is not None
        p.recorder.install(None)
        assert p.tracing._recorder is None and p.events._recorder is None


# -- time series -------------------------------------------------------------

TIERS = ((10.0, 4), (60.0, 3), (600.0, 2))


def _feed_store(p, n, seed, tiers=TIERS, max_bytes=4 << 20, spill=None):
    clock = _fake_clock(10_000.0)
    store = p.timeseries.TimeSeriesStore(tiers=tiers, max_bytes=max_bytes,
                                         spill_dir=spill, clock=clock)
    rng = np.random.default_rng(seed)
    total = 0.0
    for i in range(n):
        total += float(rng.integers(0, 50))
        flat = {
            "ingest_lag_seconds_sum": ("counter", total / 7.0),
            "ingest_lag_seconds_count": ("counter", float(i + 1)),
            'ingest_ticks_total{status="applied"}': ("counter", total),
            "ingest_queue_depth": ("gauge", float(rng.integers(0, 5))),
        }
        store.append_flat(flat, clock() + i * 10.0)
    return store, clock


@pytest.mark.parametrize("n,seed", [(3, 0), (9, 1), (40, 2), (120, 3)])
def test_tier_rollups_equal_jax(n, seed):
    def run(p):
        store, clock = _feed_store(p, n, seed)
        q = [store.query("ingest_queue_depth"),
             store.query("ingest_ticks_total", {"status": "applied"}),
             store.query("ingest_queue_depth", step=60.0),
             store.query("ingest_lag_seconds_sum", start=10_000.0,
                         end=10_000.0 + n * 5.0)]
        return (q, store.stats(), store.series_names(),
                store.recent_window(300.0),
                store._dump_locked())

    got = _both(run)
    assert json.dumps(got["torch"], sort_keys=True, default=str) == \
        json.dumps(got["jax"], sort_keys=True, default=str)


def test_series_cap_equal_jax():
    def run(p):
        store, _ = _feed_store(p, 20, 4, max_bytes=1500)
        return store.stats(), store.series_names()

    got = _both(run)
    assert got["torch"] == got["jax"]


def test_series_keys_and_flatten_equal_jax():
    reg_calls = []
    for p in PKGS.values():
        reg = p.obs.MetricsRegistry()
        reg.enabled = True
        c = reg.counter("ingest_ticks_total", "t", labelnames=("status",))
        h = reg.histogram("ingest_lag_seconds", "l", buckets=(0.1, 1.0))
        c.inc(3, status="applied")
        h.observe(0.5)
        h.observe(2.0)
        flat = p.timeseries.flatten_snapshot(reg.snapshot())
        reg_calls.append((flat, [p.timeseries.parse_series_key(k)
                                 for k in sorted(flat)],
                          p.timeseries.series_key("x", {"b": "2", "a": 1})))
    assert reg_calls[0] == reg_calls[1]


@pytest.mark.parametrize("damage", [None, "orphan_tmp", "torn_snap"])
def test_atomic_spill_and_load_equal_jax(tmp_path, damage):
    def run(p):
        spill = tmp_path / p.obs.__name__.split(".")[0] / "telemetry"
        store, _ = _feed_store(p, 15, 5, spill=str(spill))
        first = store.spill()
        store.append_flat({"ingest_queue_depth": ("gauge", 9.0)}, 20_000.0)
        store.spill()
        store.spill()
        if damage == "orphan_tmp":
            (spill / ".tmp-snap-000009").mkdir()
        elif damage == "torn_snap":
            (spill / "snap-000002" / "series.json").write_text("{")
        seen = []
        p.events._observer = seen.append
        again = p.timeseries.TimeSeriesStore(tiers=TIERS,
                                             spill_dir=str(spill))
        loaded = again.load_spill()
        p.events._observer = None
        files = {}
        for dirpath, _dirs, names in os.walk(spill):
            for name in names:
                full = os.path.join(dirpath, name)
                with open(full, "rb") as f:
                    files[os.path.relpath(full, spill)] = f.read()
        return (os.path.basename(first), os.path.basename(loaded or ""),
                again._dump_locked(), files,
                [(r["event"], r.get("reason")) for r in seen])

    got = _both(run)
    assert got["torch"] == got["jax"]


def test_sampler_tick_equal_jax(tmp_path):
    def run(p):
        p.obs.enable_metrics(True)
        p.obs.get_registry().counter(
            "ingest_ticks_total", "t", labelnames=("status",)).inc(
                4, status="applied")
        clock = _fake_clock(5000.0)
        store = p.timeseries.TimeSeriesStore(tiers=TIERS, clock=clock)
        sampler = p.timeseries.TelemetrySampler(store, 1.0, clock=clock)
        for _ in range(3):
            sampler.sample_once()
            clock.advance(10.0)
        with pytest.raises(ValueError, match="interval_s"):
            p.timeseries.TelemetrySampler(store, 0.0)
        return sampler.ticks, store.query("ingest_ticks_total",
                                          {"status": "applied"})

    got = _both(run)
    assert got["torch"] == got["jax"]


# -- SLOs --------------------------------------------------------------------

SLO_SPECS = ["lat:latency:threshold_ms=50,window_s=60,target=0.9",
             "err:error_rate:target=0.95,window_s=120",
             "api:latency:threshold_ms=20,route=/tiles",
             "fresh:staleness:max_age_s=30"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burn_rates_and_breach_edges_equal_jax(seed):
    def run(p):
        engine = p.slo.install_specs(SLO_SPECS)
        seen = []
        p.events._observer = lambda rec: (seen.append(rec["event"]),
                                          engine.observe(rec))
        rng = np.random.default_rng(seed)
        t0 = 1_700_000_000.0
        statuses = []
        for step in range(12):
            now = t0 + step * 20.0
            for i in range(int(rng.integers(0, 30))):
                engine.observe({
                    "event": "http_request", "ts": now + i * 0.1,
                    "route": ("/tiles", "/query")[i % 2],
                    "status": int(rng.choice([200, 200, 200, 503])),
                    "ms": float(rng.gamma(2.0, 20.0))})
            if rng.random() < 0.5:
                engine.observe({"event": "ingest_tick", "ts": now})
            statuses.append(engine.status(now=now + 1.0))
            statuses.append(engine.burn_snapshot(now=now + 1.0))
        return statuses, seen, p.slo.slo_status(now=t0 + 300.0)

    got = _both(run)
    assert got["torch"] == got["jax"]
    assert "slo_breach" in got["torch"][1]


@pytest.mark.parametrize("spec", [
    "x", "x:nope", "x:latency", "x:staleness", "x:latency:threshold_ms",
    "x:latency:threshold_ms=1,bogus=2", "x:error_rate:target=1.5",
    ":latency:threshold_ms=1", "x:error_rate:window_s=0"])
def test_slo_spec_refusals_equal_jax(spec):
    msgs = []
    for p in PKGS.values():
        with pytest.raises(ValueError) as exc:
            p.slo.parse_slo_spec(spec)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_slo_offline_ingest_log_equal_jax(tmp_path):
    path = tmp_path / "events.jsonl"
    log = jobs.EventLog(str(path))
    jobs.set_event_log(log)
    for i in range(20):
        jobs.emit("http_request", route="/tiles",
                  status=200 + 303 * (i % 5 == 0), ms=float(i))
    jobs.emit("ingest_tick", tick=0, points=5, seconds=0.1)
    jobs.set_event_log(None)
    log.close()

    def run(p):
        engine = p.slo.SLOEngine([p.slo.parse_slo_spec(s)
                                  for s in SLO_SPECS])
        n = engine.ingest_log(str(path))
        st = engine.status(now=max(r["ts"] for r in
                                   p.obs.read_events(str(path))) + 5.0)
        return n, st

    got = _both(run)
    assert got["torch"] == got["jax"]


# -- incidents ---------------------------------------------------------------


def _bundle_view(root):
    """{bundle name less run id: {file: parsed content}} with the run id
    and the recorder's random identities taken out."""
    out = {}
    for name in sorted(os.listdir(root)):
        full = os.path.join(root, name)
        if not os.path.isdir(full):
            continue
        files = {}
        for fname in sorted(os.listdir(full)):
            with open(os.path.join(full, fname)) as f:
                doc = json.load(f)
            if fname == "manifest.json":
                # Sizes follow metrics.json, whose registry holds each
                # package's own series (the JAX one also serve's).
                for k in ("run_id", "bytes"):
                    doc.pop(k)
                doc["files"] = sorted(doc["files"])
            if fname == "metrics.json":
                doc = {k: v for k, v in doc.items()
                       if k.startswith(("incidents_", "recorder_",
                                        "anomalies_", "ingest_"))}
            if fname == "events.json":
                doc = [{k: (os.path.basename(v) if k == "path" else v)
                        for k, v in r.items()
                        if k not in ("run_id", "ts", "trace_id", "span_id")}
                       for r in doc]
            if fname == "trace.json":
                doc = sorted(e["name"] for e in doc["traceEvents"]
                             if e.get("ph") == "X")
            files[fname] = doc
        out[name.rsplit("-", 1)[1]] = files
    return out


@pytest.mark.parametrize("interval", [0.0, 30.0])
def test_bundles_and_rate_limit_equal_jax(tmp_path, interval):
    def run(p):
        out = tmp_path / p.obs.__name__.split(".")[0]
        clock = _fake_clock()
        p.recorder.install(p.recorder.FlightRecorder(max_spans=16))
        mgr = p.incident.IncidentManager(
            str(out), run_id="run", min_interval_s=interval, keep=3,
            min_age_s=0.0, storm_threshold=3, clock=clock)
        p.incident.set_manager(mgr)
        p.incident.add_state_provider("delta", lambda: {"live_deltas": 2})
        p.incident.add_state_provider("broken", lambda: 1 / 0)
        p.tracing.end_span(p.tracing.begin_span("ingest.tick"))
        paths = [p.incident.trigger("exception", detail="boom")]
        clock.advance(10.0)
        paths.append(p.incident.trigger("exception", detail="again"))
        for i in range(3):  # a fault storm over the events' own ts
            mgr.on_event({"event": "fault_injected", "ts": 5.0 + i,
                          "site": "ingest.tick"})
        mgr.on_event({"event": "slo_breach", "slo": "fresh"})
        mgr.on_event({"event": "anomaly_detected",
                      "series": "ingest_lag_seconds"})
        return ([None if x is None else os.path.basename(x) for x in paths],
                mgr.suppressed, _bundle_view(str(out)),
                p.obs.INCIDENTS_TOTAL.value(trigger="exception"))

    got = _both(run)
    assert got["torch"] == got["jax"]


def test_size_cap_trims_tails_like_jax(tmp_path):
    """Both packages trim the event tail oldest-first, by the same
    halving steps, until the bundle fits. (The cut point also depends
    on metrics.json, whose registry differs between the packages, so
    each is held to the rule, not to the other's length.)"""
    steps = [400]
    while steps[-1]:
        steps.append(steps[-1] - (steps[-1] // 2 + 1))

    def run(p):
        out = tmp_path / p.obs.__name__.split(".")[0]
        rec = p.recorder.FlightRecorder(max_events=400)
        p.recorder.install(rec)
        for i in range(400):
            rec.record_event({"event": "http_request", "ts": float(i),
                              "seq": i, "route": "/tiles" * 20})
        mgr = p.incident.IncidentManager(str(out), run_id="r",
                                         max_bytes=20_000,
                                         clock=_fake_clock())
        path = mgr.trigger("exception")
        with open(os.path.join(path, "events.json")) as f:
            tail = [r["seq"] for r in json.load(f)]
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return tail, manifest["bytes"]

    for tail, size in _both(run).values():
        assert tail == list(range(400 - len(tail), 400))
        assert len(tail) in steps[1:] and size <= 20_000


def test_prune_age_wins_equal_jax(tmp_path):
    def run(p):
        out = tmp_path / p.obs.__name__.split(".")[0]
        mgr = p.incident.IncidentManager(str(out), run_id="r", keep=2,
                                         min_age_s=100.0,
                                         min_interval_s=0.0)
        for i in range(5):
            d = out / f"old-{i}"
            d.mkdir()
            os.utime(d, (1000.0 + i, 1000.0 + i))
        (out / ".tmp-x").mkdir()
        young = mgr.prune(now=1050.0)  # every bundle younger than 100 s
        old = mgr.prune(now=5000.0)
        return young, old, sorted(os.listdir(out))

    got = _both(run)
    assert got["torch"] == got["jax"]


def test_trigger_noop_without_manager_equal_jax():
    for p in PKGS.values():
        assert p.incident.trigger("exception") is None
        p.incident.add_state_provider("x", lambda: 1)
    assert incident.TRIGGER_KINDS == jincident.TRIGGER_KINDS


# -- anomaly watches ---------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "ingest_lag_seconds:z=6", "ingest_ticks_total:z=3,alpha=0.5",
    "ingest_queue_depth:z=2,min_count=4,clear_ratio=0.8",
    "ingest_lag_seconds"])
def test_anomaly_edges_equal_jax(spec):
    def run(p):
        ws = p.anomaly.parse_watch_spec(spec)
        engine = p.anomaly.AnomalyEngine([ws], clock=_fake_clock())
        p.anomaly.set_engine(engine)
        p.obs.enable_metrics(True)
        seen = []
        p.events._observer = seen.append
        rng = np.random.default_rng(7)
        total, count, ticks = 0.0, 0, 0.0
        for i in range(60):
            spike = 40 <= i < 44
            lag = float(rng.normal(0.2, 0.01)) * (50.0 if spike else 1.0)
            total += lag
            count += 1
            ticks += 10 + (200 if spike else int(rng.integers(0, 3)))
            flat = {
                "ingest_lag_seconds_sum": ("counter", total),
                "ingest_lag_seconds_count": ("counter", float(count)),
                'ingest_ticks_total{status="applied"}': ("counter", ticks),
                "ingest_queue_depth": ("gauge",
                                       9.0 if spike else float(i % 2)),
            }
            engine.observe_tick(flat, 1000.0 + 10.0 * i)
        p.events._observer = None
        return (ws, engine.status(), engine.edges,
                [(r["event"], r["series"], r["watch"]) for r in seen],
                p.obs.ANOMALIES_TOTAL.value(watch=ws.name))

    got = _both(run)
    assert got["torch"][0].__dict__ == got["jax"][0].__dict__
    assert got["torch"][1:] == got["jax"][1:]
    assert got["torch"][2] >= 1  # the spike rises at least once


@pytest.mark.parametrize("spec", ["", ":z=6", "x:z", "x:bogus=1", "x:z=a",
                                  "x:z=0", "x:alpha=2"])
def test_watch_spec_refusals_equal_jax(spec):
    msgs = []
    for p in PKGS.values():
        with pytest.raises(ValueError) as exc:
            p.anomaly.parse_watch_spec(spec)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# -- guards and the CLI ------------------------------------------------------

CLOCK_PATTERN = re.compile(
    r"(?:(?<![\w.])print\(|time\.perf_counter\(|(?<![\w.])time\.sleep\()")


@pytest.mark.parametrize("rel", [
    "heatmap_tpu_torch/obs/slo.py", "heatmap_tpu_torch/obs/recorder.py",
    "heatmap_tpu_torch/obs/incident.py", "heatmap_tpu_torch/obs/anomaly.py",
    "heatmap_tpu_torch/obs/timeseries.py",
    "heatmap_tpu_torch/ingest/loop.py"])
def test_no_unsanctioned_clocks(rel):
    """The reference's banned-clock grep: these modules run on event and
    span timestamps, monotonic loop clocks and injectable wall clocks;
    no print, perf_counter or sleep."""
    with open(os.path.join(REPO, rel)) as f:
        offenders = [i for i, line in enumerate(f, 1)
                     if CLOCK_PATTERN.search(line.split("#", 1)[0])]
    assert not offenders, f"{rel}: {offenders}"


def test_tracing_has_one_sanctioned_clock():
    with open(os.path.join(REPO, "heatmap_tpu_torch/obs/tracing.py")) as f:
        hits = [line for line in f if CLOCK_PATTERN.search(line)]
    assert len(hits) == 1 and "# sanctioned:" in hits[0]


def _run_levels(tmp_path, name, extra, capsys):
    out = tmp_path / name
    assert tcli.main(["run", "--input", "synthetic:3000:2", "--output",
                      f"arrays:{out}", "--detail-zoom", "12",
                      "--device", "cpu", *extra]) == 0
    capsys.readouterr()
    files = {}
    for name in sorted(os.listdir(out)):
        with open(out / name, "rb") as f:
            files[name] = f.read()
    return files


@pytest.mark.parametrize("extra", [
    [],
    ["--flight-recorder-spans", "0", "--telemetry-sample-interval", "0"],
])
def test_run_with_the_six_flags_off_installs_nothing(tmp_path, capsys,
                                                     extra, monkeypatch):
    seen = []
    real = tcli._setup_tracing

    def spy(args):
        collector = real(args)
        seen.append((tracing._recorder, events._recorder, events._observer,
                     slo.get_engine(), incident.get_manager(),
                     timeseries.get_store(), anomaly.get_engine()))
        return collector

    monkeypatch.setattr(tcli, "_setup_tracing", spy)
    _run_levels(tmp_path, "off", extra, capsys)
    assert seen == [(None,) * 7]


def test_run_blobs_unchanged_by_the_six_flags(tmp_path, capsys):
    off = _run_levels(tmp_path, "off", [], capsys)
    inc = tmp_path / "inc"
    on = _run_levels(tmp_path, "on", [
        "--events", str(tmp_path / "ev.jsonl"),
        "--slo", "fresh:staleness:max_age_s=30",
        "--flight-recorder-spans", "64", "--incident-dir", str(inc),
        "--tail-latency-ms", "1", "--telemetry-sample-interval", "0.05",
        "--watch", "stage_duration_seconds:z=6"], capsys)
    assert on == off
    assert os.path.isdir(inc / "telemetry")
    for r in obs.read_events(str(tmp_path / "ev.jsonl")):
        obs.validate_event(r)


@pytest.mark.parametrize("flags,match", [
    (["--flight-recorder-spans", "-1"], "flight-recorder-spans"),
    (["--tail-latency-ms", "0", "--events", "E"], "tail-latency-ms"),
    (["--telemetry-sample-interval", "-1"], "telemetry-sample-interval"),
    (["--watch", "x:z=6"], "--watch requires"),
    (["--watch", "x:bogus=1", "--telemetry-sample-interval", "1"],
     "--watch"),
    (["--slo", "x:nope"], "--slo"),
])
def test_telemetry_flag_refusals(tmp_path, flags, match):
    flags = [str(tmp_path / "ev.jsonl") if f == "E" else f for f in flags]
    with pytest.raises(SystemExit, match=match):
        tcli.main(["run", "--input", "synthetic:100", "--output",
                   "memory:", "--device", "cpu", *flags])
    # A refused flag leaves obs as it was.
    assert slo.get_engine() is None and recorder.get_recorder() is None
    assert timeseries.get_store() is None and not obs.metrics_enabled()


def test_failing_job_flushes_exception_bundle(tmp_path, capsys):
    inc = tmp_path / "inc"
    with pytest.raises(SystemExit):
        tcli.main(["update", "--journal", str(tmp_path / "s"), "--input",
                   "synthetic:100", "--device", "cpu", "--weighted",
                   "--incident-dir", str(inc)])
    bundles = [d for d in os.listdir(inc) if not d.startswith(".")]
    assert len(bundles) == 1
    with open(inc / bundles[0] / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["trigger"] == "exception"
    assert incident.get_manager() is None
