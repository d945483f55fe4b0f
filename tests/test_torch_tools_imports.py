"""The measuring-tool twins stand alone: importing each leaves ``jax``
and ``heatmap_tpu`` out of ``sys.modules``; without CUDA and without
``--device cpu`` each twin that uses the card raises instead of falling
back to the CPU, and host work (``tilefs_convert``, ``load_gen`` over a
given store) runs and records ``device`` "host"; a twin without
``--out`` writes under ``build/torch_bench/``, never a root
``BENCH_*.json``. ``_epoch`` has no ``main``: it is loaded by path
(``test_torch_tools_onchip.py``); ``apply_decisions`` reads state on the
host."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

TWINS = ("bench_writeplane", "bench_temporal", "bench_query",
         "bench_synopsis", "mem_probe", "tilefs_convert", "soak", "load_gen",
         "chaos_soak", "multiproc_check", "_epoch",
         "verify_partitioned_onchip", "sweep_partitioned", "apply_decisions")
#: The twins whose work runs on the card (load_gen's store job).
CARD_TWINS = tuple(t for t in TWINS
                   if t not in ("tilefs_convert", "_epoch", "apply_decisions"))
#: Arguments of the twins that take no ``--out``.
ARGV = {"chaos_soak": ["--only", "heartbeat"], "multiproc_check": [],
        "verify_partitioned_onchip": [], "sweep_partitioned": []}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_twins_import_neither_jax_nor_the_jax_package():
    script = (
        "import importlib, sys\n"
        f"for name in {TWINS!r}:\n"
        "    m = importlib.import_module('heatmap_tpu_torch.tools.' + name)\n"
        "    assert callable(getattr(m, 'main', None)) or name == '_epoch', "
        "name\n"
        "    bad = sorted(k for k in sys.modules if k in ('jax', "
        "'heatmap_tpu') or k.startswith(('jax.', 'heatmap_tpu.')))\n"
        "    assert not bad, (name, bad)\n")
    proc = subprocess.run([sys.executable, "-c", script], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("name", CARD_TWINS)
def test_twin_without_cuda_raises(name, tmp_path, monkeypatch):
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"heatmap_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main(ARGV.get(name, ["--out", str(tmp_path / "x")]))
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["tilefs_convert", "load_gen"])
def test_host_twin_runs_without_cuda(name, tmp_path, monkeypatch):
    import importlib

    import torch

    from heatmap_tpu_torch.io import open_sink, open_source
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job

    store = tmp_path / "store"
    with open_sink(f"arrays:{store}") as sink:
        run_job(open_source("synthetic:2000:1"), sink,
                BatchJobConfig(detail_zoom=10, min_detail_zoom=6),
                device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"heatmap_tpu_torch.tools.{name}")
    record = tmp_path / "record.json"
    if name == "tilefs_convert":
        argv = [f"arrays:{store}", "--record", str(record)]
    else:
        argv = ["--store", f"arrays:{store}", "--workers", "1",
                "--duration", "0.2", "--tiles", "8", "--out", str(record)]
    assert mod.main(argv) == 0
    doc = json.loads(record.read_text())
    assert doc["device"] == "host" and "gpu_name" not in doc


def test_default_record_path(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "heatmap_tpu_torch.tools.bench_writeplane",
         "--points", "600", "--writers", "1", "--micro-batch", "300",
         "--device", "cpu"],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads((tmp_path / "build" / "torch_bench" /
                      "bench_writeplane.json").read_text())
    assert doc["device"] == "cpu" and doc["results"][0]["byte_identical"]
    assert not list(tmp_path.glob("BENCH_*.json"))
