"""``heatmap_tpu_torch.tools.bench_query`` on the CPU against
``tools/bench_query.py`` at a tiny size: the same record keys, zoom,
per-op and router keys and artifact bytes; the same uniform points; and
argument checkers that refuse exactly what the JAX ones refuse, with the
same messages."""

import json
import sys

import numpy as np
import pytest

from test_torch_tools import _jax_tool, _reset  # noqa: F401

from heatmap_tpu_torch.tools import bench_query

ARGV = ["--points", "3000", "--iters", "10"]


def test_bench_query_twin_equals_jax_tool(tmp_path, monkeypatch):
    assert bench_query.main([*ARGV, "--device", "cpu", "--out",
                             str(tmp_path / "t.json")]) == 0
    jtool = _jax_tool("bench_query")
    monkeypatch.setattr(sys, "argv", ["bench_query.py", *ARGV, "--out",
                                      str(tmp_path / "j.json")])
    assert jtool.main() == 0
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert list(want) == list(bench_query.RECORD_KEYS)
    assert list(got) == [*bench_query.RECORD_KEYS, "device"]
    assert got["device"] == "cpu"
    for key in ("bench", "points", "zoom", "iters", "bytes"):
        assert got[key] == want[key], key
    assert got["bytes"]
    assert list(got["direct"]) == list(want["direct"]) == [
        "sum", "topk", "quantile"]
    for op, row in got["direct"].items():
        assert list(row) == list(want["direct"][op]), op
    assert list(got["router"]) == list(want["router"])
    assert got["router"]["requests"] == want["router"]["requests"] == 10


def test_uniform_source_equals_jax():
    jtool = _jax_tool("bench_query")
    got = list(bench_query.UniformSource(70_000, 3).batches())
    want = list(jtool._UniformSource(70_000, 3).batches())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in g:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]))


def _outcome(fn, text):
    try:
        return ("ok", fn(text))
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("checker,texts", [
    ("_ops_list", ["sum", "sum,topk", " quantile , sum ", "", ",", " , ",
                   "bogus", "sum,bogus", "topk_growth", "SUM"]),
    ("_top_k", ["1", "10", "0", "-3", "x", "1.5", " 7 "]),
    ("_quantile_q", ["0", "1", "0.5", "-0.1", "1.0001", "nan", "inf", "q",
                     "1e-9"]),
])
def test_argument_checkers_refuse_what_jax_refuses(checker, texts):
    jtool = _jax_tool("bench_query")
    for text in texts:
        assert _outcome(getattr(bench_query, checker), text) == _outcome(
            getattr(jtool, checker), text), (checker, text)


def test_bad_ops_flag_exits_2():
    with pytest.raises(SystemExit) as exc:
        bench_query.main(["--ops", "bogus", "--device", "cpu"])
    assert exc.value.code == 2
