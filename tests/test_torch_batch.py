"""The whole slice on the CPU: heatmap_tpu's ``run_batch`` and the port's
``run_batch(device="cpu")`` on the same seeded rows give equal
``as_json=True`` blob dicts (byte-identical JSON strings), under each
config the port supports. Fractional weighted sums are held to
``rtol=1e-12``, the f64 summation-order bound the JAX package states for
them. Also: cascade state carried across with ``levels_from_numpy``,
the port's refusals, its CLI, and its import hygiene."""

import json
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatmap_tpu.io.sources import SyntheticSource as JaxSyntheticSource
from heatmap_tpu.ops import sparse_partitioned as jsp
from heatmap_tpu.pipeline import batch as jbatch
from heatmap_tpu.pipeline import cascade as jcascade
from heatmap_tpu_torch import interop
from heatmap_tpu_torch.io import MemorySink, SyntheticSource, open_sink
from heatmap_tpu_torch.pipeline import batch as tbatch
from heatmap_tpu_torch.pipeline import cascade as tcascade

REPO = pathlib.Path(__file__).resolve().parent.parent
N_POINTS = 1500


def _rows(n=N_POINTS, seed=3, values=None):
    rows = list(JaxSyntheticSource(n=n, seed=seed).rows())
    # A few all-invalid points (pole, lon == 180) ride along.
    rows += [
        {"latitude": 90.0, "longitude": 0.0, "user_id": "user-1",
         "source": "gps", "timestamp": 1_500_000_000},
        {"latitude": 10.0, "longitude": 180.0, "user_id": "rt-1",
         "source": "gps", "timestamp": 1_500_000_000},
    ]
    if values is not None:
        v = values(np.random.default_rng(seed), len(rows))
        for r, x in zip(rows, v):
            r["value"] = float(x)
    return rows


def _both(rows, **cfg):
    want = jbatch.run_batch(rows, jbatch.BatchJobConfig(**cfg), as_json=True)
    got = tbatch.run_batch(rows, tbatch.BatchJobConfig(**cfg), as_json=True,
                           device="cpu")
    return got, want


CONFIGS = {
    "default": {},
    "timespans": {"timespans": ("alltime", "month")},
    "amplify_all": {"amplify_all": True},
    "first_timespan_only": {"timespans": ("month", "alltime"),
                            "first_timespan_only": True},
    "weighted_integer": {"weighted": True},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_blobs_equal_jax(name):
    cfg = CONFIGS[name]
    values = ((lambda rng, n: rng.integers(0, 100, n))
              if cfg.get("weighted") else None)
    got, want = _both(_rows(values=values), **cfg)
    assert len(want) > 100
    assert got == want


def test_partitioned_backend_equal_jax_interpret(monkeypatch):
    """``cascade_backend="partitioned"`` on both sides: the port's plain
    segment reduce against the Pallas kernel in interpret mode, at a
    shallower cascade (8 levels) and a one-pass exactness slab."""
    monkeypatch.setattr(jsp, "DEFAULT_SLAB", 8192)
    cfg = {"cascade_backend": "partitioned", "detail_zoom": 16,
           "min_detail_zoom": 7}
    got, want = _both(_rows(), **cfg)
    assert len(want) > 50
    assert got == want
    # And the same job on the port's scatter backend.
    cfg["cascade_backend"] = "scatter"
    scatter = tbatch.run_batch(_rows(), tbatch.BatchJobConfig(**cfg),
                               as_json=True, device="cpu")
    assert scatter == got


def test_weighted_partitioned_bounded_integers_equal_jax_scatter():
    rows = _rows(values=lambda rng, n: rng.integers(0, 101, n))
    want = jbatch.run_batch(rows, jbatch.BatchJobConfig(weighted=True),
                            as_json=True)
    got = tbatch.run_batch(
        rows, tbatch.BatchJobConfig(weighted=True, weight_bound=100,
                                    cascade_backend="partitioned"),
        as_json=True, device="cpu")
    assert got == want


def test_weighted_fractional_within_rtol():
    got, want = _both(_rows(values=lambda rng, n: rng.random(n) * 10),
                      weighted=True)
    assert got.keys() == want.keys()
    for k in want:
        g, w = json.loads(got[k]), json.loads(want[k])
        assert g.keys() == w.keys()
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   rtol=1e-12)


def test_levels_from_numpy_round_trip_through_port_egress():
    """A JAX cascade's per-level state, carried into the port, decodes
    and egresses to the JAX package's own blobs."""
    rng = np.random.default_rng(9)
    n, n_slots = 3000, 6
    ccfg = jcascade.CascadeConfig(detail_zoom=14, min_detail_zoom=6)
    codes = rng.integers(0, 1 << 28, n).astype(np.int64) & ~0xFF
    slots = rng.integers(0, n_slots, n).astype(np.int64)
    valid = rng.random(n) < 0.95
    levels = jcascade.run_cascade(
        jnp.asarray(codes), jnp.asarray(slots), ccfg, n_slots=n_slots,
        valid=jnp.asarray(valid), capacity=n)
    level_np = [tuple(np.asarray(x) for x in lvl) for lvl in levels]
    slot_names = {s: (("all", "u1", "u2")[s % 3], ("alltime", "2020")[s // 3])
                  for s in range(n_slots)}
    want = jcascade.json_blobs_from_level_arrays(jcascade.finalize_level_arrays(
        jcascade.decode_levels(levels, ccfg), ccfg, slot_names))
    tcfg = tcascade.CascadeConfig(detail_zoom=14, min_detail_zoom=6)
    t_levels = interop.levels_from_numpy(level_np, device="cpu")
    got = tcascade.json_blobs_from_level_arrays(tcascade.finalize_level_arrays(
        tcascade.decode_levels(t_levels, tcfg), tcfg, slot_names))
    assert len(want) > 10
    assert got == want
    # The port's own cascade on the same inputs gives the same state.
    mine = tcascade.run_cascade(
        torch.as_tensor(codes), torch.as_tensor(slots), tcfg, n_slots=n_slots,
        valid=torch.as_tensor(valid), capacity=n)
    for (gu, gs, gn), (wu, ws, wn) in zip(interop.levels_to_numpy(mine),
                                          level_np):
        assert gn == int(wn)
        np.testing.assert_array_equal(gu, wu)
        np.testing.assert_array_equal(gs, ws)
    for (gu, gs, gn), (wu, ws, wn) in zip(interop.levels_to_numpy(t_levels),
                                          level_np):
        assert gn == int(wn)
        np.testing.assert_array_equal(gu, wu)
        np.testing.assert_array_equal(gs, ws)


def test_synthetic_source_same_stream_as_jax():
    a = list(SyntheticSource(n=5000, seed=4).batches(1500))
    b = list(JaxSyntheticSource(n=5000, seed=4).batches(1500))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def test_run_job_memory_sink_and_empty_inputs():
    sink = MemorySink()
    blobs = tbatch.run_job(SyntheticSource(n=800, seed=2), sink,
                           device="cpu")
    want = jbatch.run_job(JaxSyntheticSource(n=800, seed=2),
                          max_points_in_flight=0)
    assert blobs == want and sink.blobs == want
    assert tbatch.run_batch([], device="cpu") == {}
    invalid = [{"latitude": 90.0, "longitude": 0.0, "user_id": "u",
                "source": "gps"}]
    assert tbatch.run_batch(invalid, device="cpu") == {}


def test_backend_resolution_and_refusals(monkeypatch):
    cfg = tbatch.BatchJobConfig()
    assert cfg.resolved_cascade_backend("cuda") == "partitioned"
    assert cfg.resolved_cascade_backend("cpu") == "scatter"
    assert tbatch.BatchJobConfig(weighted=True).resolved_cascade_backend(
        "cuda") == "scatter"
    for kw, match in [
        ({"cascade_backend": "bogus"}, "unknown cascade backend"),
        ({"weighted": True, "cascade_backend": "partitioned"}, "weight_bound"),
        ({"weight_bound": 5}, "needs weighted=True"),
        ({"weighted": True, "weight_bound": 0}, ">= 1"),
        ({"weighted": True, "weight_bound": 20_000,
          "cascade_backend": "partitioned"}, "exactness limit"),
    ]:
        with pytest.raises(ValueError, match=match):
            tbatch.BatchJobConfig(**kw)
        with pytest.raises(ValueError, match=match):
            jbatch.BatchJobConfig(**kw)
    # Keys of 61 bits (zoom 29, 8 slots) run on the partitioned backend,
    # which the JAX package refuses above 60 bits (ROADMAP F9), and give
    # the scatter backend's levels; 63 bits (32 slots) overflow int64 and
    # are refused on both.
    ccfg = tcascade.CascadeConfig(detail_zoom=29, min_detail_zoom=20)
    gen = torch.Generator().manual_seed(29)
    codes = torch.randint(0, 1 << 58, (64,), generator=gen)
    codes[32:] = codes[:32] ^ 1
    slots = torch.randint(0, 8, (64,), generator=gen)
    slots[-1] = 7
    levels = {b: tcascade.build_cascade(codes, slots, ccfg, n_slots=8,
                                        backend=b)
              for b in ("partitioned", "scatter")}
    assert tcascade.build_cascade.key_bits == 61
    assert int(levels["scatter"][0][0].max()).bit_length() == 61
    for got, want in zip(levels["partitioned"], levels["scatter"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    for backend in ("partitioned", "scatter"):
        with pytest.raises(ValueError, match="overflow int64"):
            tcascade.build_cascade(codes, slots, ccfg, n_slots=32,
                                   backend=backend)
    # CUDA by default, with no quiet fallback to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.run_batch(_rows(n=10))


def test_cli_run_cpu(tmp_path):
    out = tmp_path / "blobs.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "heatmap_tpu_torch", "run", "--input",
         "synthetic:600:1", "--output", f"jsonl:{out}", "--device", "cpu",
         "--timespans", "alltime,year"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = open_sink(f"jsonl:{out}").load(str(out))
    want = jbatch.run_job(
        JaxSyntheticSource(n=600, seed=1),
        config=jbatch.BatchJobConfig(timespans=("alltime", "year")),
        max_points_in_flight=0)
    assert got == {k: json.loads(v) for k, v in want.items()}


def test_import_hygiene():
    """The port imports neither JAX nor the JAX package."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import heatmap_tpu_torch, heatmap_tpu_torch.cli, "
         "heatmap_tpu_torch.interop, heatmap_tpu_torch.bench, "
         "heatmap_tpu_torch.kernel_cases, heatmap_tpu_torch.native, "
         "heatmap_tpu_torch.faults, heatmap_tpu_torch.utils, "
         "heatmap_tpu_torch.pipeline.feeder, heatmap_tpu_torch.io.hmpb, "
         "heatmap_tpu_torch.io.png, heatmap_tpu_torch.io.sinks, "
         "heatmap_tpu_torch.ops.histogram, "
         "heatmap_tpu_torch.ops.pallas_kernels, "
         "heatmap_tpu_torch.ops.partitioned, heatmap_tpu_torch.ops.pyramid, "
         "heatmap_tpu_torch.ops.splat, heatmap_tpu_torch.tilemath.tile, "
         "heatmap_tpu_torch.streaming, heatmap_tpu_torch.ingest, "
         "heatmap_tpu_torch.io.merge, heatmap_tpu_torch.io.sources, "
         "heatmap_tpu_torch.obs, heatmap_tpu_torch.obs.report, "
         "heatmap_tpu_torch.delta, heatmap_tpu_torch.delta.recover, "
         "heatmap_tpu_torch.delta.retract, heatmap_tpu_torch.delta.metrics, "
         "heatmap_tpu_torch.synopsis, heatmap_tpu_torch.analytics, "
         "heatmap_tpu_torch.tilefs, heatmap_tpu_torch.ingest.metrics, "
         "heatmap_tpu_torch.serve, heatmap_tpu_torch.tilemath.keys, "
         "heatmap_tpu_torch.analytics.query, heatmap_tpu_torch.cli, "
         "heatmap_tpu_torch.parallel.partition, heatmap_tpu_torch.writeplane, "
         "heatmap_tpu_torch.serve.router, heatmap_tpu_torch.serve.fleet, "
         "heatmap_tpu_torch.temporal, heatmap_tpu_torch.temporal.timequery, "
         "heatmap_tpu_torch.temporal.metrics, sys; "
         "assert 'jax' not in sys.modules, 'jax imported'; "
         "assert 'heatmap_tpu' not in sys.modules, 'heatmap_tpu imported'"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|heatmap_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "heatmap_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
