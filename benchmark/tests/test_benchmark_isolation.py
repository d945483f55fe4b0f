"""No module the benchmark runs is JAX or the JAX package, and the
reference imports nothing of the program.

Module names are compared by their top-level name, the part before the
first dot, as a whole: ``heatmap_tpu_torch`` begins with ``heatmap_tpu``
and is not it.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

from benchmark import harness, spec

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_forbidden_is_compared_by_whole_top_level_name():
    assert "heatmap_tpu_torch" not in harness.FORBIDDEN
    sys.modules.setdefault("heatmap_tpu_torch_probe", sys)
    try:
        assert "heatmap_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["heatmap_tpu_torch_probe"]


def test_reference_imports_only_numpy_and_itself():
    for path in sorted((BENCH / "reference").glob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("heatmap_tpu_torch", "heatmap_tpu", "jax",
                               "jaxlib", "flax", "torch"), (path, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path, name)


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


_CHILD = """
import json, sys, time, torch
from benchmark import harness, spec
from benchmark.tests.conftest import tiny
for name in [w["name"] for w in spec.load_spec()["workloads"]]:
    for trace in (False, True):
        harness.run_cell(tiny(name), 3, 0.2, trace, torch.device("cpu"),
                         time.perf_counter())
    cell = spec.cell(name)
    for m in cell.end_to_end + cell.per_layer:
        spec.metric_reader(m["name"])
import benchmark.calibrate, benchmark.run
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_every_module_a_run_loads():
    """A process that runs every cell (window and traced) through the
    harness, and loads every reader, the CLI and the calibration, holds
    no forbidden module."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "heatmap_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def _cli(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return
    out = _cli(ROOT, "--workload", "geolife-z16.bulk", "--seed",
               str(2**31 + 5), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_cli_alone_in_a_bare_directory_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    has no program: the run exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in spec.load_spec()["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path, "--workload", "geolife-batch.job", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
