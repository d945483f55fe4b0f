"""The port's bench-tool twins (``heatmap_tpu_torch.tools``) on the CPU
against the JAX tools (``tools/bench_job.py``, ``bench_delta.py``,
``bench_ingest.py``) at the same tiny sizes: the same record keys, the
same numbers where the input alone fixes them (blobs, rows, keys,
ticks, points), the same synthetic HMPB bytes, and records written under
``build/torch_bench/`` by default."""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

from heatmap_tpu import obs as jobs
from heatmap_tpu.obs import tracing as jtracing
from heatmap_tpu.utils import trace as jtrace
from heatmap_tpu_torch import obs as tobs
from heatmap_tpu_torch.obs import tracing as ttracing
from heatmap_tpu_torch.tools import bench_delta, bench_ingest, bench_job
from heatmap_tpu_torch.utils import trace as ttrace

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _reset():
    yield
    for obs, tracing, trace in ((tobs, ttracing, ttrace),
                                (jobs, jtracing, jtrace)):
        tracing.disable_tracing()
        obs.enable_metrics(False)
        obs.get_registry().reset()
        trace.enable_stage_tracing(False)
        trace.get_tracer().reset()


def _last_json(text):
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def test_bench_job_twin_equals_jax_tool(tmp_path):
    n = 4096
    out = tmp_path / "bj.json"
    r = subprocess.run(
        [sys.executable, "-m", "heatmap_tpu_torch.tools.bench_job",
         "--n", str(n), "--egress", "json", "--device", "cpu",
         "--out", str(out)],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr[-3000:]
    (got,) = json.loads(out.read_text())["results"]
    assert list(got) == list(bench_job.RECORD_KEYS)
    assert got["device"] == "cpu" and got["n_points"] == n
    assert (tmp_path / "bj_stderr.log").exists()

    jtool = _jax_tool("bench_job")
    paths = [tmp_path / "t.hmpb", tmp_path / "j.hmpb"]
    bench_job.synth_hmpb(str(paths[0]), n)
    jtool.synth_hmpb(str(paths[1]), n)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jtool.run_single(argparse.Namespace(
            cpu=False, cascade_backend=None, trace_stages=False,
            egress="json", hmpb=str(paths[1]), run=0, n=n)) == 0
    want = _last_json(buf.getvalue())
    assert list(bench_job.RECORD_KEYS) == list(want)
    for key in ("n_points", "cascade_backend", "egress", "out", "run"):
        assert got[key] == want[key], key
    assert set(got["stages"]) == set(want["stages"])
    assert set(got["run_report"]) == set(want["run_report"])
    assert set(got["trace"]) == set(want["trace"])


def test_bench_job_twin_trace_stages_and_default_out(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "heatmap_tpu_torch.tools.bench_job",
         "--n", "2048", "--egress", "none", "--device", "cpu",
         "--cascade-backend", "both", "--trace-stages"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.loads((tmp_path / "build" / "torch_bench" /
                      "bench_job.json").read_text())
    scatter, partitioned = doc["results"]
    assert (scatter["cascade_backend"], partitioned["cascade_backend"]) == (
        "scatter", "partitioned")
    assert scatter["out"] == partitioned["out"]
    for rec in (scatter, partitioned):
        assert {"cascade.sort", "cascade.segment-reduce"} <= set(
            rec["stages"])


def test_bench_delta_twin_equals_jax_tool(tmp_path, monkeypatch):
    argv = ["--base-points", "3000", "--ratios", "10"]
    assert bench_delta.main([*argv, "--device", "cpu", "--out",
                             str(tmp_path / "t.json")]) == 0
    ttracing.disable_tracing()
    jtool = _jax_tool("bench_delta")
    monkeypatch.setattr(sys, "argv", ["bench_delta.py", *argv, "--out",
                                      str(tmp_path / "j.json")])
    assert jtool.main() == 0
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert list(got) == [*bench_delta.RECORD_KEYS, "device"]
    assert list(want) == list(bench_delta.RECORD_KEYS)
    assert got["device"] == "cpu"
    (grow,), (wrow,) = got["results"], want["results"]
    assert list(grow) == list(wrow) == list(bench_delta.RESULT_KEYS)
    for key in ("ratio", "base_points", "delta_points", "full_rows",
                "delta_rows", "affected_keys"):
        assert grow[key] == wrow[key], key
    assert set(got["trace"]) == set(want["trace"])


def test_bench_ingest_twin_equals_jax_tool(tmp_path, monkeypatch):
    argv = ["--points", "1500", "--micro-batches", "1000"]
    assert bench_ingest.main([*argv, "--device", "cpu", "--out",
                              str(tmp_path / "t.json")]) == 0
    jtool = _jax_tool("bench_ingest")
    monkeypatch.setattr(sys, "argv", ["bench_ingest.py", *argv, "--out",
                                      str(tmp_path / "j.json")])
    assert jtool.main() == 0
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert list(got) == [*bench_ingest.RECORD_KEYS, "device"]
    assert list(want) == list(bench_ingest.RECORD_KEYS)
    assert [r["mode"] for r in got["results"]] == ["exact", "pow2"]
    for grow, wrow in zip(got["results"], want["results"]):
        assert list(grow) == list(wrow) == list(bench_ingest.RESULT_KEYS)
        for key in ("micro_batch", "mode", "ticks", "points", "compiles",
                    "cache_hits", "keys_invalidated"):
            assert grow[key] == wrow[key], key
    exact, pow2 = got["results"]
    assert exact["points"] == pow2["points"] == 1500
    assert exact["keys_invalidated"] == pow2["keys_invalidated"]
