"""BENCHMARK.json names only files that exist and keeps to its contract."""

from __future__ import annotations

import json
import pathlib
import re

import pytest

from benchmark import spec

SPEC = spec.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found(name):
    cell = spec.cell(name, spec=SPEC)
    assert cell.chips in (1, 4)
    assert spec.driver_class(cell) is not None
    assert set(cell.traffic["limits"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found(name):
    assert callable(spec.metric_reader(name))


def test_names_units_and_keys():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
        + SPEC["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key], e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        for w in m["workloads"]:
            cell = spec.cell(w, spec=SPEC)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(set(METRICS)) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    with open(spec.ROOT / entry["file"]) as f:
        cfg = json.load(f)
    assert entry["file"].startswith("benchmark/")
    assert cfg["source"] == entry["source"] and len(entry["source"]) <= 200
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert cfg["guarantees"]
    for key in entry["reduced"]:
        assert key in cfg


def test_each_config_used_and_pairs_unique():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {m["name"] for m in SPEC["per_layer"]}.isdisjoint(
        m["name"] for m in SPEC["end_to_end"])


def test_metric_without_workloads_goes_to_every_cell_of_its_metric():
    """A per-layer metric that lists no cells is due in every cell that
    reports the end-to-end metric it moves, cells added later too."""
    extra = dict(SPEC, per_layer=SPEC["per_layer"] + [
        {"name": "host_ms.job", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "ingest", "moves": "job_s"}])
    for w in SPEC["workloads"]:
        e2e, per_layer = spec.metrics_of(extra, w["name"])
        reports = "job_s" in {m["name"] for m in e2e}
        assert ("host_ms.job" in {m["name"] for m in per_layer}) == reports


def test_reader_of_a_split_metric_is_its_stem():
    """``idle_pct.bulk`` and ``idle_pct.job`` have no files of their own:
    ``metrics/idle_pct.py`` reads both; a name with a file of its own is
    read by that file."""
    def file_of(name):
        return pathlib.Path(spec.metric_reader(name).__code__.co_filename)

    stem = spec.HERE / "metrics" / "idle_pct.py"
    assert file_of("idle_pct.bulk") == file_of("idle_pct.job") == stem
    assert file_of("project_ms.bulk").name == "project_ms.bulk.py"
