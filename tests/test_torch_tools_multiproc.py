"""``heatmap_tpu_torch.tools.multiproc_check`` on the CPU.

Two real port processes over a gloo group run every check of the twin
(gather, weighted, bounded, sharded and columnar egress, the
data-parallel merges, the kernels' cross-process merge), each held by
the children to the port's single-process ``run_job``; here that oracle
is held to the JAX package's single-process ``run_job`` on the same
source and config (blobs and level arrays), the bar
``tools/multiproc_check.py`` sets, whose own multi-process test is a
slow one. ``--skew-only`` runs the skewed byte exchange."""

import json
import os

import numpy as np
import pytest

from heatmap_tpu.io.sinks import LevelArraysSink as JLevelArraysSink
from heatmap_tpu.io.sources import SyntheticSource as JSyntheticSource
from heatmap_tpu.pipeline import BatchJobConfig as JBatchJobConfig
from heatmap_tpu.pipeline import run_job as jrun_job
from heatmap_tpu_torch.io.sinks import LevelArraysSink
from heatmap_tpu_torch.io.sources import SyntheticSource
from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job
from heatmap_tpu_torch.tools import multiproc_check

N = 3000


def _lines(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_two_processes_pass_every_check(capsys):
    assert multiproc_check.main(["--k", "2", "--n", str(N),
                                 "--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    children, verdict = lines[:-1], lines[-1]
    assert sorted(c["pid"] for c in children) == [0, 1]
    for child in children:
        assert child["ok"] and all(child["checks"].values()), child
    # Process 0 also reassembles the per-host shards.
    (zero,) = [c for c in children if c["pid"] == 0]
    assert zero["checks"]["sharded_union_equals_oracle"]
    assert zero["checks"]["columnar_union_equals_oracle"]
    assert len(zero["checks"]) == 14
    assert {k: verdict[k] for k in ("check", "ok", "k", "n", "device")} == {
        "check": "multiproc", "ok": True, "k": 2, "n": N, "device": "cpu"}
    assert verdict["launches"]["segment_reduce"] == 0  # plain versions


@pytest.mark.parametrize("k", [2, 3])
def test_skew_exchange(k, capsys):
    assert multiproc_check.main(["--k", str(k), "--skew-only",
                                 "--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    assert sorted(x["pid"] for x in lines[:-1]) == list(range(k))
    assert all(x["checks"] == {"skew_alltoall": True} for x in lines[:-1])
    assert lines[-1]["ok"] and lines[-1]["device"] == "host"


def test_timeout_reaps_every_child(capsys):
    assert multiproc_check.main(["--k", "2", "--timeout", "0.01",
                                 "--device", "cpu"]) == 1
    assert _lines(capsys.readouterr().out)[-1]["ok"] is False


def _weighted(source_cls):
    class WSrc:
        n = N

        def batches(self, batch_size):
            off = 0
            for b in source_cls(n=N, seed=13).batches(batch_size):
                m = len(b["latitude"])
                b = dict(b)
                b["value"] = ((np.arange(off, off + m) % 7) + 1).astype(
                    np.float64)
                off += m
                yield b
    return WSrc()


@pytest.mark.parametrize("weighted", [False, True])
def test_oracle_equals_jax_run_job(weighted, tmp_path):
    """The children's oracle (blobs and level arrays) is the JAX
    package's single-process job."""
    kw = dict(detail_zoom=11, min_detail_zoom=8, weighted=weighted)
    src = _weighted(SyntheticSource) if weighted else SyntheticSource(
        n=N, seed=13)
    jsrc = _weighted(JSyntheticSource) if weighted else JSyntheticSource(
        n=N, seed=13)
    got = run_job(src, config=BatchJobConfig(**kw), batch_size=256,
                  max_points_in_flight=0, device="cpu")
    want = jrun_job(jsrc, config=JBatchJobConfig(**kw), batch_size=256,
                    max_points_in_flight=0)
    assert got.keys() == want.keys() and got
    assert all(json.loads(got[k]) == json.loads(want[k]) for k in want)
    if weighted:
        return
    a, b = str(tmp_path / "t"), str(tmp_path / "j")
    run_job(SyntheticSource(n=N, seed=13), LevelArraysSink(a),
            config=BatchJobConfig(**kw), batch_size=256,
            max_points_in_flight=0, device="cpu")
    jrun_job(JSyntheticSource(n=N, seed=13), JLevelArraysSink(b),
             config=JBatchJobConfig(**kw), batch_size=256,
             max_points_in_flight=0)
    la, lb = LevelArraysSink.load(a), JLevelArraysSink.load(b)
    assert la.keys() == lb.keys()
    for z in la:
        for col in ("row", "col", "value", "user", "timespan"):
            np.testing.assert_array_equal(np.asarray(la[z][col]),
                                          np.asarray(lb[z][col]))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


def test_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        multiproc_check.main(["--k", "2"])
