"""The port's ``run`` and ``convert`` commands on the CPU against
``python -m heatmap_tpu run|convert --backend cpu``: the same JSONL
bytes from a CSV (automatic fast path), with ``--no-fast``, chunked,
with a checkpoint dir, and from an HMPB file the port converted; the
same HMPB bytes; ``arrays:`` output; and the flag conflicts exiting
non-zero before any work."""

import csv
import importlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from heatmap_tpu.io.sources import SyntheticSource as JaxSyntheticSource
from heatmap_tpu_torch import cli
from heatmap_tpu_torch.io import LevelArraysSink
from heatmap_tpu_torch import native


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    """The JAX reference with its native library. heatmap_tpu.native
    builds at import without a lock, so under ``pytest -n`` on a fresh
    checkout a worker can lose that race and import it without its
    library; it then loads the port's locked build instead (also what
    ``python -m heatmap_tpu`` subprocesses of this module load)."""
    from heatmap_tpu import native as jnative

    if jnative._lib is None:
        path = native.build()
        assert path, "the native library does not build"
        os.environ["HEATMAP_TPU_NATIVE_LIB"] = path
        importlib.reload(jnative)
    assert jnative.available()

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = ["--detail-zoom", "12", "--min-detail-zoom", "6",
       "--timespans", "alltime,month"]


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "pts.csv"
    rows = list(JaxSyntheticSource(n=1200, seed=5).rows())
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["latitude", "longitude", "user_id", "source",
                    "timestamp"])
        for r in rows:
            w.writerow([repr(r["latitude"]), repr(r["longitude"]),
                        r["user_id"], r["source"], r["timestamp"] * 1000])
    return str(path)


def _cli(package, *args):
    extra = []
    if args[0] == "run":
        extra = (["--backend", "cpu"] if package == "heatmap_tpu"
                 else ["--device", "cpu"])
    proc = subprocess.run([sys.executable, "-m", package, *args, *extra],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc


@pytest.fixture(scope="module")
def jax_jsonl(csv_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "blobs.jsonl"
    _cli("heatmap_tpu", "run", "--input", f"csv:{csv_path}", "--output",
         f"jsonl:{out}", *CFG)
    return out.read_bytes()


@pytest.mark.parametrize("flags", [[], ["--no-fast"], ["--fast"],
                                   ["--max-points-in-flight", "400"],
                                   ["--checkpoint-dir", "CKPT",
                                    "--checkpoint-every", "1",
                                    "--batch-size", "300"]],
                         ids=["auto_fast", "no_fast", "fast", "chunked",
                              "checkpoint"])
def test_run_csv_same_jsonl_bytes(csv_path, jax_jsonl, tmp_path, flags):
    out = tmp_path / "blobs.jsonl"
    flags = [str(tmp_path / "ckpt") if f == "CKPT" else f for f in flags]
    proc = _cli("heatmap_tpu_torch", "run", "--input", f"csv:{csv_path}",
                "--output", f"jsonl:{out}", *CFG, *flags)
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["ingest"] == ("standard" if {"--no-fast", "--checkpoint-dir"}
                                 & set(flags) else "fast")
    assert summary["blobs"] == len(jax_jsonl.splitlines()) > 100
    assert out.read_bytes() == jax_jsonl


def test_convert_then_run_hmpb_same_bytes(csv_path, jax_jsonl, tmp_path):
    t, j = tmp_path / "t.hmpb", tmp_path / "j.hmpb"
    proc = _cli("heatmap_tpu_torch", "convert", "--input", f"csv:{csv_path}",
                "--output", str(t))
    _cli("heatmap_tpu", "convert", "--input", f"csv:{csv_path}", "--output",
         str(j))
    assert json.loads(proc.stdout)["n"] == 1200
    assert t.read_bytes() == j.read_bytes()
    out = tmp_path / "blobs.jsonl"
    proc = _cli("heatmap_tpu_torch", "run", "--input", f"hmpb:{t}",
                "--output", f"jsonl:{out}", *CFG)
    assert json.loads(proc.stdout.strip().splitlines()[-1])["ingest"] == \
        "fast"
    assert out.read_bytes() == jax_jsonl


def test_run_arrays_output_equal_jax(csv_path, tmp_path):
    _cli("heatmap_tpu", "run", "--input", f"csv:{csv_path}", "--output",
         f"arrays:{tmp_path / 'jax'}", *CFG)
    proc = _cli("heatmap_tpu_torch", "run", "--input", f"csv:{csv_path}",
                "--output", f"arrays:{tmp_path / 'port'}", *CFG)
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["levels"] == 6 and summary["rows"] > 0
    got = LevelArraysSink.load(str(tmp_path / "port"))
    want = LevelArraysSink.load(str(tmp_path / "jax"))
    assert got.keys() == want.keys()
    for z in want:
        assert got[z].keys() == want[z].keys()
        for k in want[z]:
            assert got[z][k].dtype == want[z][k].dtype
            np.testing.assert_array_equal(got[z][k], want[z][k])


@pytest.mark.parametrize("flags,match", [
    (["--merge-spill-dir", "/tmp/s", "--checkpoint-dir", "/tmp/c"],
     "--merge-spill-dir"),
    (["--max-points-in-flight", "10", "--checkpoint-dir", "/tmp/c"],
     "mutually exclusive"),
    (["--fast", "--no-fast"], "mutually exclusive"),
    (["--fast"], "needs a csv or hmpb source"),
    (["--timespans", "week"], "unknown type"),
])
def test_flag_conflicts_exit_nonzero(flags, match):
    with pytest.raises(SystemExit) as err:
        cli.main(["run", "--input", "synthetic:100", "--output", "memory:",
                  "--device", "cpu", *flags])
    assert err.value.code not in (0, None)
    assert match in str(err.value.code)
