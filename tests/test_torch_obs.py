"""The port's telemetry core (heatmap_tpu_torch.obs) on the CPU against
the JAX package's: metrics text with the same names, labels and counts
for the same calls; event logs that validate against the shared schema;
``blob_checksum``; span trees; the tracer's stage hooks, the fault and
retry counters and the stream's counters; ``run``'s telemetry flags,
whose blobs are byte-identical to a run without them; ``--profile``."""

import json
import os

import numpy as np
import pytest

from heatmap_tpu import cli as jcli
from heatmap_tpu import faults as jfaults
from heatmap_tpu import obs as jobs
from heatmap_tpu import streaming as jstreaming
from heatmap_tpu.obs import metrics as jmetrics
from heatmap_tpu.obs import tracing as jtracing
from heatmap_tpu.ops.histogram import window_from_bounds as jwindow
from heatmap_tpu.utils import trace as jtrace
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import faults as tfaults
from heatmap_tpu_torch import obs
from heatmap_tpu_torch import streaming as tstreaming
from heatmap_tpu_torch.io import LevelArraysSink
from heatmap_tpu_torch.obs import metrics as tmetrics
from heatmap_tpu_torch.obs import tracing
from heatmap_tpu_torch.ops.histogram import window_from_bounds
from heatmap_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    """Process-wide telemetry of the port, cleared after each test (the
    JAX package's is cleared by tests/conftest.py)."""
    yield
    trace.get_tracer().reset()
    obs.enable_metrics(False)
    obs.get_registry().reset()
    log = obs.get_event_log()
    if log is not None:
        log.close()
        obs.set_event_log(None)
    tracing.disable_tracing()
    tfaults.install(None)


def _registry_calls(mod):
    reg = mod.MetricsRegistry()
    reg.enabled = True
    c = reg.counter("points_total", "Points", labelnames=("backend",))
    g = reg.gauge("depth", "Queue depth")
    h = reg.histogram("apply_seconds", "Apply", labelnames=("kind",),
                      buckets=(0.01, 0.1, 1.0))
    rng = np.random.default_rng(3)
    for v in rng.integers(1, 100, 20):
        c.inc(int(v), backend="partitioned" if v % 2 else "scatter")
    g.set(7)
    g.set(3.5)
    for v in rng.random(30) * 2:
        h.observe(float(v), kind="insert" if v < 1 else "retract")
    c.inc(5, backend='we"ird\\label\n')
    return reg


def test_metrics_text_and_snapshot_equal_jax(tmp_path):
    got, want = _registry_calls(tmetrics), _registry_calls(jmetrics)
    assert got.render_prometheus() == want.render_prometheus()
    assert got.snapshot() == want.snapshot()
    got.write_prometheus(str(tmp_path / "a" / "metrics.prom"))
    want.write_prometheus(str(tmp_path / "b" / "metrics.prom"))
    assert ((tmp_path / "a" / "metrics.prom").read_bytes()
            == (tmp_path / "b" / "metrics.prom").read_bytes())
    # Off: every mutation is a no-op.
    off = tmetrics.MetricsRegistry()
    off.counter("x_total").inc(3)
    assert off.render_prometheus() == ""


def test_shared_handles_match_jax():
    """Every handle the port defines is the JAX package's series: same
    name, kind, help text and labels."""
    got = obs.get_registry().snapshot()
    want = jobs.get_registry().snapshot()
    assert len(got) >= 15
    for name, spec in got.items():
        assert name in want, name
        for k in ("type", "help", "labelnames"):
            assert spec[k] == want[name][k], (name, k)


@pytest.mark.parametrize("items", [None, 0, 12345])
def test_record_stage_equal_jax(tmp_path, items):
    for mod, log_path in ((obs, tmp_path / "t.jsonl"),
                          (jobs, tmp_path / "j.jsonl")):
        mod.enable_metrics(True)
        log = mod.EventLog(str(log_path), run_id="r1")
        mod.set_event_log(log)
        mod.record_stage("cascade.chunk", 0.25, items=items,
                         backend="partitioned", level=None)
        mod.set_event_log(None)
        log.close()
    assert (obs.get_registry().render_prometheus()
            == jobs.get_registry().render_prometheus())
    got = obs.read_events(str(tmp_path / "t.jsonl"))
    want = jobs.read_events(str(tmp_path / "j.jsonl"))
    strip = lambda recs: [{k: v for k, v in r.items() if k != "ts"}
                          for r in recs]
    assert strip(got) == strip(want)


def test_event_schema_and_validation_equal_jax(tmp_path):
    assert obs.EVENT_SCHEMA == jobs.EVENT_SCHEMA
    log = obs.EventLog(str(tmp_path / "ev" / "e.jsonl"))
    obs.set_event_log(log)
    obs.emit("delta_applied", epoch=1, points=10, sign=1, seconds=0.5)
    obs.emit("compaction_end", root="r", seconds=1.0, status="ok")
    with pytest.raises(ValueError, match="unknown field"):
        obs.emit("delta_applied", epoch=1, points=1, sign=1, seconds=0,
                 bogus=1)
    with pytest.raises(ValueError, match="missing required"):
        obs.emit("run_end")
    with pytest.raises(ValueError, match="unknown event"):
        obs.emit("no_such_event")
    obs.set_event_log(None)
    log.close()
    assert obs.emit("run_end", status="ok") is None  # no log: no-op
    recs = obs.read_events(str(tmp_path / "ev" / "e.jsonl"))
    assert [r["seq"] for r in recs] == [0, 1]
    for r in recs:
        obs.validate_event(r)
        jobs.validate_event(r)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blob_checksum_equal_jax(seed):
    rng = np.random.default_rng(seed)
    blobs = {}
    for i in range(int(rng.integers(0, 50))):
        key = f"user-{i}|alltime|{int(rng.integers(0, 9))}_1_2"
        blobs[key] = (json.dumps({"a": float(rng.random())}) if i % 2
                      else {"z": [int(v) for v in rng.integers(0, 9, 3)]})
    assert obs.blob_checksum(blobs) == jobs.blob_checksum(blobs)


def test_span_trees_and_chrome_export_like_jax(tmp_path):
    """The same span nesting under both tracers gives the same tree
    shape and export keys; stage_end events carry the span ids."""
    shapes = []
    for mod, tr, trace_mod, name in ((obs, tracing, trace, "t"),
                                     (jobs, jtracing, jtrace, "j")):
        collector = mod.enable_tracing(sample=1.0, seed=0)
        log = mod.EventLog(str(tmp_path / f"{name}.jsonl"))
        mod.set_event_log(log)
        root = tr.begin_span("update")
        with trace_mod.span("delta.read"):
            pass
        with tr.span("delta.compute", sign=1):
            with trace_mod.span("ingest.batch", items=3):
                pass
        tr.end_span(root)
        mod.set_event_log(None)
        log.close()
        n = collector.export_chrome(str(tmp_path / f"{name}.trace.json"))
        doc = json.loads((tmp_path / f"{name}.trace.json").read_text())
        names = sorted(e["name"] for e in doc["traceEvents"]
                       if e.get("ph") == "X")
        summary = collector.summary()
        shapes.append((n, names, sorted(doc), sorted(summary)))
        for rec in mod.read_events(str(tmp_path / f"{name}.jsonl")):
            assert rec["event"] == "stage_end" and rec["trace_id"]
        mod.disable_tracing()
    assert shapes[0] == shapes[1]
    assert shapes[0][1] == ["delta.compute", "delta.read", "ingest.batch",
                            "update"]
    with pytest.raises(ValueError):
        obs.enable_tracing(sample=1.5)


def test_fault_and_retry_counters_equal_jax(tmp_path):
    """A fired fault and its retry count in both packages' registries
    and event logs the same way."""
    spec = "seed=7,scale=0,sink.write=2"
    for mod, fmod, name in ((obs, tfaults, "t"), (jobs, jfaults, "j")):
        mod.enable_metrics(True)
        log = mod.EventLog(str(tmp_path / f"{name}.jsonl"))
        mod.set_event_log(log)
        fmod.install_spec(spec)
        calls = []
        assert fmod.retry_call(lambda: calls.append(1) or 5,
                               site="sink.write", key="arrays") == 5
        assert calls == [1]
        fmod.install(None)
        mod.set_event_log(None)
        log.close()
    assert (obs.get_registry().render_prometheus()
            == jobs.get_registry().render_prometheus())
    assert "faults_injected_total" in obs.get_registry().render_prometheus()
    strip = lambda recs: [{k: v for k, v in r.items()
                           if k not in ("ts", "run_id")} for r in recs]
    assert (strip(obs.read_events(str(tmp_path / "t.jsonl")))
            == strip(jobs.read_events(str(tmp_path / "j.jsonl"))))


def test_stream_counters_equal_jax():
    """HeatmapStream.update and the default tick hook feed the stream
    series as the JAX package's do."""
    rng = np.random.default_rng(4)
    ticks = [(float(10 * i), {"latitude": rng.uniform(46, 49, 300),
                              "longitude": rng.uniform(-124, -120, 300),
                              "user_id": ["u"] * 300})
             for i in range(3)]
    for mod, smod, win in ((obs, tstreaming, window_from_bounds),
                           (jobs, jstreaming, jwindow)):
        mod.enable_metrics(True)
        cfg = smod.StreamConfig(window=win((46, 49), (-124, -120), 8),
                                half_life_s=60.0)
        extra = {"device": "cpu"} if smod is tstreaming else {}
        stream = smod.HeatmapStream(cfg, **extra)
        smod.run_stream(stream, ticks)
    got = obs.get_registry().render_prometheus()
    assert got == jobs.get_registry().render_prometheus()
    assert "stream_ticks_total 3" in got and "stream_points_total 900" in got


def test_telemetry_off_is_free():
    assert not obs.telemetry_enabled()
    obs.record_stage("x", 1.0, items=3)
    obs.record_fault("sink.write", 0)
    assert obs.get_registry().render_prometheus() == ""
    assert obs.sample_device_memory() == []
    assert trace._tree_begin is None


def _run(cli, tmp_path, out, *flags, capsys=None):
    argv = ["run", "--input", "synthetic:3000:2", "--detail-zoom", "12",
            "--timespans", "alltime,month", "--output", out, *flags]
    argv += ["--device", "cpu"] if cli is tcli else ["--backend", "cpu"]
    assert cli.main(argv) == 0
    if capsys is not None:
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["jsonl", "arrays"])
def test_run_telemetry_flags_byte_identical(tmp_path, capsys, kind):
    """``run`` with --events/--metrics-dir/--report/--trace-out writes
    the same bytes as without them (and as the JAX run); the events
    validate, the metrics and the report exist."""
    def out(name):
        p = tmp_path / name
        return f"jsonl:{p}.jsonl" if kind == "jsonl" else f"arrays:{p}"

    plain = _run(tcli, tmp_path, out("plain"), capsys=capsys)
    tel = tmp_path / "tel"
    got = _run(tcli, tmp_path, out("tele"), "--events",
               str(tel / "events.jsonl"), "--metrics-dir", str(tel),
               "--report", str(tel / "report.json"), "--trace-out",
               str(tel / "trace.json"), capsys=capsys)
    _run(jcli, tmp_path, out("jax"))
    for k in ("output", "seconds"):
        plain.pop(k), got.pop(k)
    assert got == plain
    if kind == "jsonl":
        a = (tmp_path / "plain.jsonl").read_bytes()
        assert a == (tmp_path / "tele.jsonl").read_bytes()
        assert a == (tmp_path / "jax.jsonl").read_bytes()
    else:
        for name in os.listdir(tmp_path / "plain"):
            a = (tmp_path / "plain" / name).read_bytes()
            assert a == (tmp_path / "tele" / name).read_bytes(), name
            assert a == (tmp_path / "jax" / name).read_bytes(), name
    recs = obs.read_events(str(tel / "events.jsonl"))
    for r in recs:
        jobs.validate_event(r)
    kinds = [r["event"] for r in recs]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert "stage_end" in kinds and "device_memory" in kinds
    assert recs[0]["devices"]["platform"] == "cpu"
    assert recs[-1]["status"] == "ok"
    if kind == "jsonl":
        assert recs[-1]["blobs"] == plain["blobs"]
        assert recs[-1]["checksum"].startswith("crc32:")
    else:
        assert recs[-1]["rows"] == plain["rows"]
    prom = (tel / "metrics.prom").read_text()
    assert "stage_duration_seconds_bucket" in prom
    report = json.loads((tel / "report.json").read_text())
    assert report["schema"] == "heatmap-tpu.run_report.v1"
    assert report["run"]["status"] == "ok" and "stages" in report
    assert json.loads((tel / "trace.json").read_text())["traceEvents"]
    # The command leaves telemetry as it found it.
    assert not obs.telemetry_enabled() and not obs.tracing_enabled()


def test_run_checksum_equals_jax_checksum(tmp_path):
    """run_end's checksum is the JAX run's for the same blobs."""
    for cli, name in ((tcli, "t"), (jcli, "j")):
        _run(cli, tmp_path, f"jsonl:{tmp_path / name}.jsonl", "--events",
             str(tmp_path / f"{name}.events.jsonl"))
    ends = [[r for r in obs.read_events(str(tmp_path / f"{n}.events.jsonl"))
             if r["event"] == "run_end"][0] for n in ("t", "j")]
    assert ends[0]["checksum"] == ends[1]["checksum"]
    assert ends[0]["blobs"] == ends[1]["blobs"]


def test_run_profile_writes_a_trace(tmp_path, capsys):
    logdir = tmp_path / "prof"
    _run(tcli, tmp_path, f"arrays:{tmp_path / 'a'}", "--profile",
         str(logdir))
    err = capsys.readouterr().err
    assert "ingest" in err  # the span/throughput table
    doc = json.loads((logdir / "trace.json").read_text())
    assert doc["traceEvents"]
    assert LevelArraysSink.load(str(tmp_path / "a"))


def test_profile_unavailable_is_recorded(tmp_path, monkeypatch):
    import torch

    class Broken:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    log = obs.EventLog(str(tmp_path / "e.jsonl"))
    obs.set_event_log(log)
    ran = []
    with trace.torch_profile(str(tmp_path / "p")):
        ran.append(1)
    obs.set_event_log(None)
    log.close()
    assert ran == [1]
    assert "profiler unavailable" in trace.get_tracer().profiler_warning
    (rec,) = obs.read_events(str(tmp_path / "e.jsonl"))
    assert rec["event"] == "profiler_unavailable"
    report = obs.build_run_report(tracer=trace.get_tracer(),
                                  events_path=str(tmp_path / "e.jsonl"))
    assert any("profiler unavailable" in w for w in report["warnings"])
