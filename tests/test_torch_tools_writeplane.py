"""``heatmap_tpu_torch.tools.bench_writeplane`` on the CPU against
``tools/bench_writeplane.py`` at a tiny size: the same record keys
(sorted, as both write them), every cell byte-identical to its
single-writer reference, and the same input-fixed numbers (tiles,
batches, points)."""

import json
import sys

from test_torch_tools import _jax_tool, _reset  # noqa: F401

from heatmap_tpu_torch.tools import bench_writeplane

ARGV = ["--points", "2000", "--writers", "1,2", "--micro-batch", "1000"]


def test_bench_writeplane_twin_equals_jax_tool(tmp_path, monkeypatch):
    assert bench_writeplane.main([*ARGV, "--device", "cpu", "--out",
                                  str(tmp_path / "t.json")]) == 0
    jtool = _jax_tool("bench_writeplane")
    monkeypatch.setattr(sys, "argv", ["bench_writeplane.py", *ARGV,
                                      "--out", str(tmp_path / "j.json")])
    assert jtool.main() == 0
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert list(want) == sorted(bench_writeplane.RECORD_KEYS)
    assert list(got) == sorted([*bench_writeplane.RECORD_KEYS, "device"])
    assert got["device"] == "cpu"
    for key in ("bench", "points", "micro_batch", "tiles"):
        assert got[key] == want[key], key
    assert got["tiles"] > 0
    assert [r["writers"] for r in got["results"]] == [1, 2]
    for grow, wrow in zip(got["results"], want["results"], strict=True):
        assert list(grow) == list(wrow) == sorted(
            bench_writeplane.RESULT_KEYS)
        for key in ("writers", "batches", "completed", "failed", "points",
                    "byte_identical"):
            assert grow[key] == wrow[key], key
        assert grow["byte_identical"] is True
        assert grow["points"] == 2000 and grow["failed"] == 0


def test_bench_writeplane_docs_equal_jax_docs(tmp_path):
    """The byte gate's documents: the port's single-writer reference
    store lists the same tiles with the same JSON bytes as the JAX
    tool's over the same micro-batches."""
    from heatmap_tpu import delta as jdelta
    from heatmap_tpu.io import open_source as jopen_source
    from heatmap_tpu.pipeline import BatchJobConfig as JConfig
    from heatmap_tpu.serve import TileStore as JTileStore

    spec = "synthetic:1500:7"
    got = bench_writeplane.reference_docs(spec, 500, str(tmp_path / "t"),
                                          "cpu")
    jtool = _jax_tool("bench_writeplane")
    # The JAX tool's reference config, as its main builds it.
    config = JConfig(detail_zoom=11, min_detail_zoom=5, result_delta=3,
                     pad_bucketing="pow2", pad_bucket_min=1 << 8)
    root = str(tmp_path / "j")
    for batch in jopen_source(spec).batches(500):
        jdelta.apply_batch(root, jdelta.ColumnsSource(batch), config)
    want = jtool._collect_docs(JTileStore(f"delta:{root}"))
    assert got and got == want
