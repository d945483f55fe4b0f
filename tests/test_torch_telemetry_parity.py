"""The batch job's telemetry at parity with the JAX package's: ``run``,
``update``, ``ingest`` and ``writeplane`` with ``--metrics-dir`` on the
CPU, through both CLIs. Every series of the JAX command's
``metrics.prom`` is in the port's; the port's only extras are its own
``delta.*`` stage series (ROADMAP F8); and the counters that follow from
the input alone (rows read, emissions binned, blobs written, faults,
retries, span and item counts per stage) are equal. A ``--chaos
source.read`` run is retried past with the bytes of a clean run in both
packages."""

import pytest

from heatmap_tpu import cli as jcli
from heatmap_tpu import faults as jfaults
from heatmap_tpu import obs as jobs
from heatmap_tpu.pipeline import bucketing as jbucketing
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import faults as tfaults
from heatmap_tpu_torch import obs as tobs
from heatmap_tpu_torch.pipeline import bucketing as tbucketing
from heatmap_tpu_torch.utils import trace as ttrace

#: The port's own stage series (ROADMAP F8): the delta apply's
#: ``delta.read``/``hash``/``compute``/``journal``/``keys`` spans, which
#: the JAX package does not record.
F8_STAGES = {"delta.read", "delta.hash", "delta.compute", "delta.journal",
             "delta.keys"}

#: Counters that follow from the input alone.
DETERMINISTIC = ("source_rows_read_total", "points_binned_total",
                 "sink_blobs_written_total", "faults_injected_total",
                 "io_retries_total", "stage_duration_seconds_count",
                 "stage_items_total")

CHAOS = "seed=7,source.read=1x2"

COMMANDS = {
    "run": lambda d: ["run", "--input", "synthetic:3000", "--output",
                      f"jsonl:{d}/out.jsonl"],
    "update": lambda d: ["update", "--journal", f"{d}/j", "--input",
                         "synthetic:3000:0", "--detail-zoom", "12"],
    "ingest": lambda d: ["ingest", "--journal", f"{d}/j", "--input",
                         "synthetic:6000:3", "--detail-zoom", "12",
                         "--micro-batch", "2048", "--compact-every", "2"],
    "writeplane": lambda d: ["writeplane", "--root", f"{d}/wp", "--input",
                             "synthetic:3000:7", "--detail-zoom", "10",
                             "--micro-batch", "1000"],
    "run-chaos": lambda d: ["run", "--input", "synthetic:3000", "--output",
                            f"jsonl:{d}/out.jsonl", "--chaos", CHAOS],
}


@pytest.fixture(autouse=True)
def _reset():
    yield
    for faults, obs in ((tfaults, tobs), (jfaults, jobs)):
        faults.install(None)
        obs.enable_metrics(False)
        obs.get_registry().reset()
    ttrace.get_tracer().reset()


def _series(path):
    """``{series: value}`` of a Prometheus text file."""
    out = {}
    for line in path.read_text().splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def _stage(series):
    if 'stage="' not in series:
        return None
    return series.split('stage="', 1)[1].split('"', 1)[0]


def _run_both(tmp_path, command):
    out = {}
    for cli, name, dev, bucketing in (
            (tcli, "t", ["--device", "cpu"], tbucketing),
            (jcli, "j", ["--backend", "cpu"], jbucketing)):
        bucketing.reset_cache_stats()
        d = tmp_path / name
        d.mkdir()
        assert cli.main([*COMMANDS[command](d), *dev, "--metrics-dir",
                         str(d / "m")]) == 0
        out[name] = _series(d / "m" / "metrics.prom")
    return out["t"], out["j"]


@pytest.mark.parametrize("command", list(COMMANDS))
def test_metrics_series_and_counters_equal_jax(tmp_path, capsys, command):
    got, want = _run_both(tmp_path, command)
    capsys.readouterr()
    missing = sorted(set(want) - set(got))
    assert not missing, missing
    extras = set(got) - set(want)
    extra_stages = {_stage(s) for s in extras}
    if command.startswith("run"):
        assert not extras, sorted(extras)
    else:
        assert extra_stages == F8_STAGES, sorted(extras)
    for series, value in want.items():
        if series.startswith(DETERMINISTIC):
            assert got[series] == value, series
    assert want['source_rows_read_total{source="synthetic"}'] > 0
    assert any(s.startswith("points_binned_total") for s in want)
    if command != "run":
        assert 'stage_duration_seconds_count{stage="cascade.project"}' in got
    if command == "run-chaos":
        assert got['faults_injected_total{site="source.read"}'] == 1
        assert got['io_retries_total{site="source.read"}'] == 1
        # The retried run writes a clean run's bytes, in both packages.
        clean = tmp_path / "clean.jsonl"
        assert tcli.main(["run", "--input", "synthetic:3000", "--output",
                          f"jsonl:{clean}", "--device", "cpu"]) == 0
        data = clean.read_bytes()
        assert (tmp_path / "t" / "out.jsonl").read_bytes() == data
        assert (tmp_path / "j" / "out.jsonl").read_bytes() == data


def test_telemetry_off_writes_the_same_bytes(tmp_path, capsys):
    """The dispatch timer's card sync and the new counters run only with
    telemetry on; a run with --metrics-dir writes a plain run's bytes."""
    for name, extra in (("plain", []),
                        ("tele", ["--metrics-dir", str(tmp_path / "m")])):
        assert tcli.main(["run", "--input", "synthetic:2000:5", "--output",
                          f"jsonl:{tmp_path / name}.jsonl", "--device",
                          "cpu", *extra]) == 0
    capsys.readouterr()
    assert ((tmp_path / "plain.jsonl").read_bytes()
            == (tmp_path / "tele.jsonl").read_bytes())
    assert not tobs.telemetry_enabled()
    got = _series(tmp_path / "m" / "metrics.prom")
    assert got['dispatch_overhead_seconds_count{dispatch="single"}'] == 1
    assert got['sink_blobs_written_total{sink="jsonl"}'] > 0
    assert got['sink_bytes_written_total{sink="jsonl"}'] == (
        tmp_path / "tele.jsonl").stat().st_size
