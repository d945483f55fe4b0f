"""The port's copies of the JAX package's runtime utilities on the CPU:
checkpoints readable across the two packages, atomic writes, keep-N
retention, ``FaultInjector``, and the tracer's span statistics with the
JAX tracer's report layout."""

import numpy as np
import pytest

from heatmap_tpu.utils import checkpoint as jckpt
from heatmap_tpu.utils import recovery as jrecovery
from heatmap_tpu.utils import trace as jtrace
from heatmap_tpu_torch.utils import checkpoint as tckpt
from heatmap_tpu_torch.utils import recovery as trecovery
from heatmap_tpu_torch.utils import trace as ttrace


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_readable_across_packages(tmp_path, writer):
    arrays = {"latitude": np.linspace(0, 1, 7),
              "group_ids": np.arange(7, dtype=np.int32),
              "timestamps_ms": np.full(7, np.iinfo(np.int64).min)}
    meta = {"group_names": ["all", "u"], "batches_done": 4,
            "job_path": "fast", "weighted": False}
    save, load = ((tckpt.save_checkpoint, jckpt.load_checkpoint)
                  if writer == "port" else
                  (jckpt.save_checkpoint, tckpt.load_checkpoint))
    path = str(tmp_path / "c.npz")
    save(path, arrays, meta)
    got, got_meta = load(path)
    assert got_meta == meta
    assert got.keys() == arrays.keys()
    for k in arrays:
        assert got[k].dtype == arrays[k].dtype
        np.testing.assert_array_equal(got[k], arrays[k])


def test_checkpoint_atomic_and_reserved(tmp_path, monkeypatch):
    path = tmp_path / "c.npz"

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save_checkpoint(str(path), {"a": np.zeros(3)})
    assert list(tmp_path.iterdir()) == []
    monkeypatch.undo()
    with pytest.raises(ValueError, match="reserved"):
        tckpt.save_checkpoint(str(path), {"__meta_json__": np.zeros(1)})


def test_checkpoint_manager_retention(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.load()
    for step in (2, 4, 6):
        mgr.save(step, {"x": np.arange(step)}, {"batches_done": step})
    assert mgr.steps() == [4, 6]
    arrays, meta = mgr.load()
    assert meta == {"batches_done": 6, "step": 6}
    # The JAX manager reads the port's directory the same way.
    jmgr = jckpt.CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert jmgr.latest_step() == 6
    np.testing.assert_array_equal(jmgr.load()[0]["x"], arrays["x"])
    mgr.prune(keep=0)
    assert mgr.steps() == []
    with pytest.raises(ValueError):
        tckpt.CheckpointManager(str(tmp_path), keep=0)


def test_fault_injector_equal_jax():
    runs = []
    for inj, exc in ((trecovery.FaultInjector({1: 2, 3: 1}), RuntimeError),
                     (jrecovery.FaultInjector({1: 2, 3: 1}), RuntimeError)):
        fired = []
        for i in [0, 1, 1, 1, 2, 3, 3]:
            try:
                inj.check(i)
                fired.append(0)
            except exc:
                fired.append(1)
        runs.append((fired, inj.injected))
    assert runs[0] == runs[1] == ([0, 1, 1, 0, 0, 1, 0], 3)


def test_tracer_report_layout_equal_jax():
    reports = []
    for mod in (ttrace, jtrace):
        tr = mod.Tracer()
        for n in (3, 5):
            with tr.span("ingest.batch", items=n):
                pass
        tr.add_items("ingest.batch", 2)
        with tr.span("egress"):
            pass
        reports.append(tr.report())
        assert "ingest.batch" in tr.format_report()
        tr.reset()
        assert tr.report() == {}
    got, want = reports
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in ("count", "items"):
            assert got[name][k] == want[name][k]
    assert got["ingest.batch"]["count"] == 2
    assert got["ingest.batch"]["items"] == 10


def test_stage_span_only_under_stage_tracing():
    tracer = ttrace.get_tracer()
    tracer.reset()
    with ttrace.stage_span("sort"):
        pass
    assert "sort" not in tracer.report()
    ttrace.enable_stage_tracing(True)
    try:
        assert ttrace.stage_tracing_enabled()
        with ttrace.stage_span("sort", items=4):
            pass
    finally:
        ttrace.enable_stage_tracing(False)
    assert tracer.report()["sort"]["items"] == 4
    with ttrace.span("run"):
        pass
    assert tracer.report()["run"]["count"] == 1
    tracer.reset()
