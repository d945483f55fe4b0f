"""``heatmap_tpu_torch.tools.bench_synopsis`` on the CPU against
``tools/bench_synopsis.py`` at a tiny size: the same record keys, the
same artifact bytes per zoom, the same re-verified ``max_err``, and the
same early-serve ticks and provisional publishes."""

import json
import sys

from test_torch_tools import _jax_tool, _reset  # noqa: F401

from heatmap_tpu_torch.tools import bench_synopsis

ARGV = ["--points", "9000", "--decode-iters", "2"]


def test_bench_synopsis_twin_equals_jax_tool(tmp_path, monkeypatch):
    assert bench_synopsis.main([*ARGV, "--device", "cpu", "--out",
                                str(tmp_path / "t.json")]) == 0
    jtool = _jax_tool("bench_synopsis")
    monkeypatch.setattr(sys, "argv", ["bench_synopsis.py", *ARGV, "--out",
                                      str(tmp_path / "j.json")])
    assert jtool.main() == 0
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert list(want) == list(bench_synopsis.RECORD_KEYS)
    assert list(got) == [*bench_synopsis.RECORD_KEYS, "device"]
    assert got["device"] == "cpu"
    assert got["points"] == want["points"]
    assert got["compression"] == want["compression"]
    assert got["compression"]["per_zoom"]
    assert list(got["decode"]) == list(want["decode"])
    for key in ("zoom", "pairs", "max_err", "verified"):
        assert got["decode"][key] == want["decode"][key], key
    assert list(got["early_serve"]) == list(want["early_serve"])
    for key in ("ticks", "provisional_publishes"):
        assert got["early_serve"][key] == want["early_serve"][key], key
    assert got["early_serve"]["provisional_publishes"] > 0


def test_fixed_chunks_equal_jax():
    jtool = _jax_tool("bench_synopsis")
    cols = {"latitude": list(range(10)), "longitude": list(range(10, 20))}
    assert list(bench_synopsis.FixedChunks(cols, 4).batches()) == list(
        jtool._FixedChunks(cols, 4).batches())
