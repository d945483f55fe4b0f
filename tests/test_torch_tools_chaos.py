"""``heatmap_tpu_torch.tools.chaos_soak`` on the CPU against
``tools/chaos_soak.py``: every phase of both tools at ``--n 1200`` (the
port with ``--device cpu``), and each phase's line equal to the JAX
tool's in the keys that are bytes, counts and verdicts. Timings, paths
and the counts that follow thread timing (a load loop's status codes,
shards reassigned before a deadline, the feeder's high-water mark)
are compared by their contract instead: no 5xx, at least one.

The two tools run as subprocesses, the phases split in four sets, all
eight processes at once (the JAX side compiles every shape anew, and
``backend_loss`` waits on a fleet child's restart)."""

import concurrent.futures as cf
import json
import os
import pathlib
import subprocess
import sys

import pytest

from test_torch_tools import _jax_tool

from heatmap_tpu_torch.tools import chaos_soak

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 1200
#: PHASES in four sets of about equal cost on the JAX side; backend_loss
#: and byte_equality need the baseline (byte_equality the chaos run).
GROUPS = (
    ("baseline", "backend_loss"),
    ("baseline", "chaos_pipeline", "chaos_serve", "heartbeat",
     "fault_floor", "synopsis", "query", "temporal", "tilefs", "incident",
     "telemetry", "adaptive", "byte_equality"),
    ("ingest_crash", "writer_loss"),
    ("dispatch", "host_loss", "host_loss_morton"),
)
#: Keys of every line that are timings or paths.
TIMING = {"seconds", "ages", "incident_dir", "feed_overlap_pct",
          "bundle_bytes"}
#: Per phase: keys that follow thread timing, held to their contract.
LOOSE = {
    "backend_loss": {"codes"},
    "host_loss": {"reassigned", "reassignments_metric"},
    "host_loss_morton": {"reassigned"},
    "dispatch": {"feeder_depth_hwm"},
    "tilefs": {"disk_cache"},
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(argv, group):
    only = [a for name in group for a in ("--only", name)]
    proc = subprocess.run([sys.executable, *argv, "--n", str(N), *only],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=600)
    lines = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if "phase" in rec:
                lines[rec["phase"]] = rec
    return proc.returncode, lines, proc.stdout, proc.stderr[-3000:]


@pytest.fixture(scope="module")
def runs():
    tools = {"port": ["-m", "heatmap_tpu_torch.tools.chaos_soak",
                      "--device", "cpu"],
             "jax": [str(ROOT / "tools" / "chaos_soak.py")]}
    with cf.ThreadPoolExecutor(2 * len(GROUPS)) as ex:
        futs = {(side, i): ex.submit(_run, argv, group)
                for side, argv in tools.items()
                for i, group in enumerate(GROUPS)}
        done = {key: f.result() for key, f in futs.items()}
    out = {}
    for (side, _), (rc, lines, stdout, stderr) in done.items():
        assert rc == 0, (side, stdout[-2000:], stderr)
        out.setdefault(side, {}).update(lines)
    return out


@pytest.mark.parametrize("phase", [name for name, _ in chaos_soak.PHASES])
def test_phase_line_equals_jax(runs, phase):
    got, want = runs["port"][phase], runs["jax"][phase]
    assert got["ok"] is True and want["ok"] is True, (got, want)
    assert got.keys() == want.keys(), (got, want)
    loose = LOOSE.get(phase, set())
    for key in want.keys() - TIMING - loose:
        assert got[key] == want[key], (phase, key, got[key], want[key])
    if phase == "backend_loss":
        for line in (got, want):
            assert not any(s.startswith("5") for s in line["codes"])
    if phase.startswith("host_loss"):
        assert got["reassigned"] > 0 and want["reassigned"] > 0
    if phase == "dispatch":
        assert got["feeder_depth_hwm"] >= 1 <= want["feeder_depth_hwm"]
    if phase == "tilefs":
        for key in ("entries", "bytes", "max_bytes"):
            assert got["disk_cache"][key] == want["disk_cache"][key], key


def test_phases_and_storms_equal_jax():
    jtool = _jax_tool("chaos_soak")
    assert ([name for name, _ in chaos_soak.PHASES]
            == [name for name, _ in jtool.PHASES])
    for name in ("DEFAULT_CHAOS", "INGEST_CHAOS", "INGEST_KILL",
                 "WRITEPLANE_CHAOS", "WRITEPLANE_KILL", "DISPATCH_CHAOS",
                 "DISPATCH_KILL", "HOST_LOSS_WEDGE", "FETCH_ATTEMPTS"):
        assert getattr(chaos_soak, name) == getattr(jtool, name), name
    assert chaos_soak.CFG == chaos_soak.BatchJobConfig(
        detail_zoom=10, min_detail_zoom=8, result_delta=2)


def test_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        chaos_soak.main(["--only", "heartbeat"])


def test_failed_phase_exits_1(monkeypatch, capsys):
    def broken(ctx):
        raise AssertionError("diverged")

    monkeypatch.setattr(chaos_soak, "PHASES", [("heartbeat", broken)])
    assert chaos_soak.main(["--device", "cpu"]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[0]["phase"] == "heartbeat" and lines[0]["ok"] is False
    assert lines[0]["error"] == "AssertionError: diverged"
    assert lines[-1] == {"failed": 1, "device": "cpu"}
