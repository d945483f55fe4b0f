"""The port's ``update`` and ``retract`` commands on the CPU against the
JAX CLI's: the same stdout summaries and the same store, with and
without the telemetry flags; ``--base`` adoption; the operator errors;
the parse-time refusals (exit 2) of the JAX flags whose modules wait for
a later slice; and the ``--bucket-*`` flags, which parse as the JAX
CLI's."""

import json
import os

import pytest

from heatmap_tpu import cli as jcli
from heatmap_tpu import obs as jobs
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import obs
from heatmap_tpu_torch.delta import recover
from heatmap_tpu_torch.obs import tracing
from heatmap_tpu_torch.utils import trace
from heatmap_tpu_torch.utils.checkpoint import load_checkpoint

ZOOM = ["--detail-zoom", "12"]


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    trace.get_tracer().reset()
    obs.enable_metrics(False)
    obs.get_registry().reset()
    obs.set_event_log(None)
    tracing.disable_tracing()
    recover.clear_verified_cache()


def _main(cli, argv, capsys):
    """One command in process on the CPU; its stdout summary."""
    argv = [*argv, *(["--device", "cpu"] if cli is tcli
                     else ["--backend", "cpu"])]
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _steps(root):
    return [
        ["update", "--journal", root, "--input", "synthetic:2500:0", *ZOOM],
        ["update", "--journal", root, "--input", "synthetic:400:1", *ZOOM],
        ["update", "--journal", root, "--input", "synthetic:400:1", *ZOOM],
        ["update", "--journal", root, "--input", "synthetic:400:2",
         "--retractions", "synthetic:400:1", *ZOOM],
        ["retract", "--journal", root, "--layer", "user-5"],
        ["retract", "--journal", root, "--where", "user=user-5",
         "--where", "source=gps"],
        ["update", "--journal", root, "--compact-after", "0",
         "--retention", "1"],
    ]


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if rel.startswith("journal" + os.sep):
                arrays, meta = load_checkpoint(full)
                meta.pop("ts")
                out[rel] = (meta, {k: v.tolist() for k, v in arrays.items()})
            else:
                with open(full, "rb") as f:
                    out[rel] = f.read()
    return out


def _clean(summary):
    """A summary without what depends on the run: seconds, paths."""
    return {k: v for k, v in summary.items()
            if k not in ("seconds", "journal")}


def test_update_and_retract_summaries_and_store_equal_jax(tmp_path, capsys):
    got = [_main(tcli, argv, capsys) for argv in _steps(str(tmp_path / "t"))]
    want = [_main(jcli, argv, capsys) for argv in _steps(str(tmp_path / "j"))]
    assert [_clean(s) for s in got] == [
        {k: (v.replace(str(tmp_path / "j"), str(tmp_path / "t"))
             if isinstance(v, str) else v) for k, v in _clean(s).items()}
        for s in want]
    assert list(got[0]) == list(want[0])  # key order too
    assert got[2]["applied"][0]["duplicate"] is True
    assert got[4]["rows"] > 0 and got[5]["rows"] == 0
    assert got[6]["compaction"]["status"] == "ok"
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def test_update_telemetry_flags_byte_identical(tmp_path, capsys):
    """``update`` with every telemetry flag writes the same store as
    without them; events validate against the JAX schema, metrics and
    the report exist, and the trace holds the delta spans."""
    plain, tele = str(tmp_path / "plain"), str(tmp_path / "tele")
    tel = tmp_path / "tel"
    flags = ["--events", str(tel / "events.jsonl"), "--metrics-dir",
             str(tel), "--report", str(tel / "report.json"), "--trace-out",
             str(tel / "trace.json")]
    for i, argv in enumerate(_steps(plain)[:4]):
        a = _main(tcli, argv, capsys)
        b = _main(tcli, [tele if x == plain else x for x in argv]
                  + (flags if i == 1 else []), capsys)
        assert _clean(a) == _clean(b)
    assert _tree(plain) == _tree(tele)
    recs = obs.read_events(str(tel / "events.jsonl"))
    for r in recs:
        jobs.validate_event(r)
    kinds = [r["event"] for r in recs]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert "delta_applied" in kinds and "stage_end" in kinds
    assert recs[-1]["status"] == "ok" and recs[-1]["rows"] > 0
    prom = (tel / "metrics.prom").read_text()
    assert 'delta_points_total{kind="insert"} 400' in prom
    assert "delta_apply_seconds_count 1" in prom
    report = json.loads((tel / "report.json").read_text())
    assert "delta.compute" in report["stages"]
    names = {e["name"] for e in json.loads(
        (tel / "trace.json").read_text())["traceEvents"]}
    assert {"update", "delta.apply", "delta.compute"} <= names


def test_retract_events(tmp_path, capsys):
    root = str(tmp_path / "s")
    _main(tcli, _steps(root)[0], capsys)
    ev = tmp_path / "ev.jsonl"
    out = _main(tcli, ["retract", "--journal", root, "--layer", "user-7",
                       "--events", str(ev)], capsys)
    recs = obs.read_events(str(ev))
    for r in recs:
        jobs.validate_event(r)
    assert [r["event"] for r in recs][-2:] == ["delta_applied",
                                               "retraction_applied"]
    assert recs[-1]["rows"] == out["rows"] > 0
    assert obs.get_event_log() is None


def test_update_base_adoption_equal_jax(tmp_path, capsys):
    for cli, name in ((tcli, "t"), (jcli, "j")):
        art = tmp_path / f"{name}_art"
        _main(cli, ["run", "--input", "synthetic:1500:3", *ZOOM,
                    "--output", f"arrays:{art}"], capsys)
        s = _main(cli, ["update", "--journal", str(tmp_path / name),
                        "--base", f"arrays:{art}", "--input",
                        "synthetic:300:4", *ZOOM, "--compact-after", "0"],
                  capsys)
        assert s["base_adopted"] == f"arrays:{art}"
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


@pytest.mark.parametrize("argv,match", [
    (["update", "--journal", "R"], "nothing to do"),
    (["update", "--journal", "R", "--base", "jsonl:x.jsonl"],
     "must be a columnar arrays:DIR"),
    (["update", "--journal", "R", "--base", "arrays:/no/such/dir"],
     "is not a directory"),
    (["update", "--journal", "R", "--input", "synthetic:10", "--no-x64"],
     "needs int64 keys"),
    (["update", "--journal", "R", "--input", "synthetic:10",
      "--timespans", "decade"], "unknown type"),
    (["retract", "--journal", "R"], "at least one --where"),
    (["retract", "--journal", "R", "--where", "colour=red"],
     "not a point column"),
])
def test_update_operator_errors(tmp_path, argv, match):
    argv = [a.replace("R", str(tmp_path / "R")) if a == "R" else a
            for a in argv]
    with pytest.raises(SystemExit, match=match):
        tcli.main([*argv, "--device", "cpu"])


def test_update_config_mismatch_is_one_line(tmp_path, capsys):
    root = str(tmp_path / "s")
    _main(tcli, ["update", "--journal", root, "--input", "synthetic:200:0",
                 *ZOOM], capsys)
    with pytest.raises(SystemExit, match="refusing to apply"):
        tcli.main(["update", "--journal", root, "--input",
                   "synthetic:200:1", "--detail-zoom", "11", "--device",
                   "cpu"])


BASE_ARGV = {
    "run": ["run", "--input", "synthetic:10"],
    "update": ["update", "--journal", "R", "--input", "synthetic:10"],
    "ingest": ["ingest", "--journal", "R", "--input", "synthetic:10"],
}


@pytest.mark.parametrize("cmd,flag,value,item", [
    ("run", "--data-parallel", "on", 7),
    ("run", "--dispatch", "gspmd", 7),
    ("update", "--dispatch", "shard_map", 7),
    ("update", "--bucket-width", "3600", 5),
    ("update", "--bucket-fanout", "4", 5),
    ("update", "--bucket-keep", "8", 5),
    ("update", "--bucket-tiers", "4", 5),
    ("update", "--bucket-unit-s", "1", 5),
])
def test_unported_flags_refused_at_parse_time(capsys, cmd, flag, value,
                                              item):
    """Values that need ``parallel/`` (item 7) exit 2 at parse time. The
    ``--bucket-*`` flags (temporal/, ported) parse to
    the JAX parser's values."""
    base = BASE_ARGV[cmd]
    if item == 5:
        args = tcli.build_parser().parse_args([*base, flag, value])
        jargs = jcli.build_parser().parse_args([*base, flag, value])
        dest = flag[2:].replace("-", "_")
        assert getattr(args, dest) == getattr(jargs, dest) == float(value)
        return
    with pytest.raises(SystemExit) as exc:
        tcli.build_parser().parse_args([*base, flag, value])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"item {item}" in err and flag in err


@pytest.mark.parametrize("flags", [
    ["--flight-recorder-spans", "0", "--telemetry-sample-interval", "0"],
    ["--data-parallel", "off", "--dispatch", "auto"],
    ["--data-parallel", "auto"],
])
def test_off_values_of_unported_flags_parse(flags):
    for base in BASE_ARGV.values():
        tcli.build_parser().parse_args([*base, *flags])
    with pytest.raises(SystemExit) as exc:
        tcli.build_parser().parse_args(["run", "--input", "synthetic:10",
                                        "--dispatch", "bogus"])
    assert exc.value.code == 2
