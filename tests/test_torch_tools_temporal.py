"""``heatmap_tpu_torch.tools.bench_temporal`` on the CPU against
``tools/bench_temporal.py`` at a tiny size: the same record keys (sorted,
as both write them), both byte gates true, and the numbers the input
alone fixes (the newest edge, fold units, retraction rows and
counter-batches, growth slots, cells and ``max_err``)."""

import json
import sys

from test_torch_tools import _jax_tool, _reset  # noqa: F401

from heatmap_tpu_torch.tools import bench_temporal

ARGV = ["--points", "1000", "--iters", "3"]


def test_bench_temporal_twin_equals_jax_tool(tmp_path, monkeypatch):
    assert bench_temporal.main([*ARGV, "--device", "cpu", "--out",
                                str(tmp_path / "t.json")]) == 0
    jtool = _jax_tool("bench_temporal")
    monkeypatch.setattr(sys, "argv", ["bench_temporal.py", *ARGV, "--out",
                                      str(tmp_path / "j.json")])
    assert jtool.main() == 0
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert list(want) == sorted(bench_temporal.RECORD_KEYS)
    assert list(got) == sorted([*bench_temporal.RECORD_KEYS, "device"])
    assert got["device"] == "cpu"
    for key in ("schema", "points", "iters", "ref_edge",
                "alltime_byte_identical"):
        assert got[key] == want[key], key
    assert got["alltime_byte_identical"] is True
    assert list(got["fold"]) == list(want["fold"])
    for cut in want["fold"]:
        assert got["fold"][cut]["units"] == want["fold"][cut]["units"], cut
    assert list(got["serve"]) == list(want["serve"])
    assert list(got["retract"]) == list(want["retract"])
    for key in ("rows", "batches", "scanned", "byte_identical"):
        assert got["retract"][key] == want["retract"][key], key
    assert got["retract"]["byte_identical"] is True
    assert list(got["growth"]) == list(want["growth"])
    for key in ("slots", "max_err", "cells"):
        assert got["growth"][key] == want["growth"][key], key


def test_bench_temporal_timed_source_equals_jax():
    jtool = _jax_tool("bench_temporal")
    got = bench_temporal.timed_source(50, 3, 1.5e9, 18_000.0)
    want = jtool._timed_source(50, 3, 1.5e9, 18_000.0)
    assert list(got) == list(want)
    for key in got:
        assert list(got[key]) == list(want[key]), key
