"""The port's continuous ingest (heatmap_tpu_torch.ingest, with
pipeline/bucketing.py and the fed delta apply) on the CPU against the JAX
package's: bucket sizes, slot rounding and padding; level arrays of
``run_job`` under every padding mode; the compile-cache mirror's hits and
misses; ``run_ingest`` drains that write byte-identical stores (journal
entries, artifacts and the compacted base) synchronously and queued, with
the feeder on and off, inserting and retracting, cut by ``max_ticks``,
after a crash mid-tick, and continued across packages; the reference's
loop properties (watermark, back-pressure, idempotent re-drain, retried
tick faults, config checks); the staleness SLO fed by ``ingest_tick``;
the rule that the content hash reads host bytes while the cascade reads
the fed tensors; and the ``ingest`` command's summary and refusals.
Detail zoom 9-12 on small seeded sources."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from heatmap_tpu import cli as jcli
from heatmap_tpu import faults as jfaults
from heatmap_tpu import ingest as jingest
from heatmap_tpu.delta.compute import ColumnsSource as JColumnsSource
from heatmap_tpu.io.sinks import LevelArraysSink as JLevelArraysSink
from heatmap_tpu.pipeline import batch as jbatch
from heatmap_tpu.pipeline import bucketing as jbucketing
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import delta, faults, ingest, obs
from heatmap_tpu_torch.delta import recover
from heatmap_tpu_torch.delta.compute import ColumnsSource
from heatmap_tpu_torch.delta.journal import batch_content_hash
from heatmap_tpu_torch.ingest import loop as loop_mod
from heatmap_tpu_torch.io import LevelArraysSink
from heatmap_tpu_torch.obs import events as events_mod
from heatmap_tpu_torch.obs import slo
from heatmap_tpu_torch.pipeline import batch as tbatch
from heatmap_tpu_torch.pipeline import bucketing
from heatmap_tpu_torch.pipeline import feeder as feeder_mod

from test_torch_delta import _tree

#: Small pyramids (z9 -> z6 blobs) keep the compactions cheap.
CFG = dict(detail_zoom=9, min_detail_zoom=5, result_delta=3)


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    bucketing.reset_cache_stats()
    faults.install(None)
    recover.clear_verified_cache()
    slo.set_engine(None)
    events_mod._observer = None
    obs.enable_metrics(False)
    obs.get_registry().reset()


def _cols(n, seed=0, t0=1.5e9, users=4, weighted=False):
    rng = np.random.default_rng(seed)
    cols = {
        "latitude": rng.uniform(37.0, 37.2, n),
        "longitude": rng.uniform(-122.2, -122.0, n),
        "user_id": [f"u{i % users}" for i in range(n)],
        "source": ["background" if i % 17 == 5 else "gps"
                   for i in range(n)],
        "timestamp": [t0 + i for i in range(n)],
    }
    if weighted:
        cols["value"] = rng.integers(0, 9, n).astype(np.float64)
    return cols


def _cfg(pkg, **kw):
    mod = tbatch if pkg == "torch" else jbatch
    return mod.BatchJobConfig(**{**CFG, "pad_bucketing": "pow2",
                                 "pad_bucket_min": 1 << 8, **kw})


def _drain(pkg, root, cols, cfg_kw=None, **ing_kw):
    """One run_ingest drain of ``cols`` by package ``pkg``."""
    ing_kw = {"micro_batch": 250, "queue_depth": None,
              "compact_every": 0, **ing_kw}
    if pkg == "torch":
        return ingest.run_ingest(
            str(root), ColumnsSource(cols), _cfg("torch", **(cfg_kw or {})),
            ingest=ingest.IngestConfig(**ing_kw), device="cpu")
    return jingest.run_ingest(
        str(root), JColumnsSource(cols), _cfg("jax", **(cfg_kw or {})),
        ingest=jingest.IngestConfig(**ing_kw))


# -- bucketing ---------------------------------------------------------------


@pytest.mark.parametrize("floor", [64, 1 << 12])
@pytest.mark.parametrize("n", [0, 1, 7, 64, 4096, 4097, 5121, 9000,
                               123_457])
@pytest.mark.parametrize("mode", ["exact", "pow2", "geometric"])
def test_bucket_size_equal_jax(mode, n, floor):
    assert (bucketing.bucket_size(n, mode, floor)
            == jbucketing.bucket_size(n, mode, floor))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 64, 65, 1000])
def test_bucket_slots_equal_jax(n):
    assert bucketing.bucket_slots(n) == jbucketing.bucket_slots(n)


def test_bucket_refusals_equal_jax():
    for mod in (bucketing, jbucketing):
        with pytest.raises(ValueError, match="unknown pad_bucketing"):
            mod.bucket_size(5, "nope")
    assert bucketing.BUCKETING_MODES == jbucketing.BUCKETING_MODES
    assert bucketing.DEFAULT_MIN_BUCKET == jbucketing.DEFAULT_MIN_BUCKET


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n,target", [(100, 128), (300, 512), (64, 64),
                                      (5, 3)])
def test_pad_emissions_equal_jax(n, target, with_valid, weighted):
    """Tensors pad on their own device to the JAX package's lanes: pad
    lanes are valid=False with zero codes, slots and weights."""
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 1 << 40, n)
    slots = rng.integers(0, 8, n).astype(np.int32)
    valid = rng.random(n) < 0.8 if with_valid else None
    w = rng.random(n) if weighted else None
    want = jbucketing.pad_emissions(codes, slots, valid, w, target)
    got = bucketing.pad_emissions(
        torch.as_tensor(codes), torch.as_tensor(slots),
        None if valid is None else torch.as_tensor(valid),
        None if w is None else torch.as_tensor(w), target)
    for g, j in zip(got, want):
        assert (g is None) == (j is None)
        if g is not None:
            assert g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
            assert g.numpy().dtype == np.asarray(j).dtype


@pytest.mark.parametrize("kw,match", [
    ({"pad_bucketing": "nope"}, "unknown pad_bucketing"),
    ({"pad_bucket_min": 0}, "pad_bucket_min"),
])
def test_config_validation_equal_jax(kw, match):
    for mod in (tbatch, jbatch):
        with pytest.raises(ValueError, match=match):
            mod.BatchJobConfig(**kw)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["exact", "pow2", "geometric"])
def test_levels_equal_jax(tmp_path, mode, weighted):
    """run_job's level arrays under each padding mode equal the JAX
    package's byte for byte (and so equal the exact mode's)."""
    cols = _cols(1500, seed=3, weighted=weighted)
    kw = dict(CFG, detail_zoom=12, weighted=weighted, pad_bucketing=mode,
              pad_bucket_min=512)
    tbatch.run_job(ColumnsSource(cols), LevelArraysSink(str(tmp_path / "t")),
                   tbatch.BatchJobConfig(**kw), device="cpu")
    jbatch.run_job(JColumnsSource(cols),
                   JLevelArraysSink(str(tmp_path / "j")),
                   jbatch.BatchJobConfig(**kw))
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


@pytest.mark.parametrize("mode", ["exact", "pow2", "geometric"])
def test_note_dispatch_mirror_equal_jax(mode):
    """The compile-cache mirror counts what the JAX package's jit would
    compile: equal hits and misses over one sequence of batch sizes."""
    sizes = [130, 190, 220, 250, 300, 420, 510, 600, 190]
    stats = {}
    for pkg, mod, bmod in (("torch", tbatch, bucketing),
                           ("jax", jbatch, jbucketing)):
        cfg = mod.BatchJobConfig(**CFG, pad_bucketing=mode,
                                 pad_bucket_min=1 << 8)
        bmod.reset_cache_stats()
        for i, n in enumerate(sizes):
            cols = _cols(n, seed=10 + i)
            kw = {"device": "cpu"} if pkg == "torch" else {}
            mod.run_job(
                (ColumnsSource if pkg == "torch" else JColumnsSource)(cols),
                None, cfg, **kw)
        stats[pkg] = bmod.cache_stats()
    assert stats["torch"] == stats["jax"]
    if mode == "exact":
        assert stats["torch"]["hits"] == 1  # only the repeated size
    else:
        assert stats["torch"]["misses"] < len(sizes) - 1


def test_pad_counter_counts_pad_lanes():
    obs.enable_metrics(True)
    codes = torch.zeros(10, dtype=torch.int64)
    bucketing.pad_emissions(codes, codes, None, None, 16)
    assert bucketing.CASCADE_PAD_EMISSIONS.value() == 6


# -- run_ingest against the JAX package --------------------------------------


@pytest.fixture(scope="module")
def jax_stores(tmp_path_factory):
    """The JAX package's stores for the drains below, made once:
    inserted with compactions, cut after two ticks, and the inserted
    store retracted batch by batch."""
    base = tmp_path_factory.mktemp("jax_ingest")
    cols = _cols(900, seed=4)
    out = {"cols": cols}
    _drain("jax", base / "insert", cols, compact_every=2, retention=4)
    out["insert"] = _tree(base / "insert")
    _drain("jax", base / "cut", cols, max_ticks=2)
    out["cut"] = _tree(base / "cut")
    _drain("jax", base / "retract", cols)
    _drain("jax", base / "retract", cols, sign=-1)
    out["retract"] = _tree(base / "retract")
    yield out
    jfaults.install(None)


@pytest.mark.parametrize("feed_depth", [0, 1, 2])
@pytest.mark.parametrize("queue_depth", [None, 2])
def test_drain_equal_jax(tmp_path, jax_stores, queue_depth, feed_depth):
    stats = _drain("torch", tmp_path / "s", jax_stores["cols"],
                   compact_every=2, retention=4, queue_depth=queue_depth,
                   feed_depth=feed_depth)
    assert stats.ticks == 4 and stats.compactions == 2
    assert stats.duplicates == 0 and len(stats.epochs) == 4
    assert _tree(tmp_path / "s") == jax_stores["insert"]
    if feed_depth:
        assert stats.feeder_depth_hwm >= 1


def test_max_ticks_equal_jax(tmp_path, jax_stores):
    stats = _drain("torch", tmp_path / "s", jax_stores["cols"],
                   max_ticks=2, queue_depth=2)
    assert stats.ticks == 2
    assert _tree(tmp_path / "s") == jax_stores["cut"]


def test_retraction_drain_equal_jax(tmp_path, jax_stores):
    cols = jax_stores["cols"]
    _drain("torch", tmp_path / "s", cols)
    stats = _drain("torch", tmp_path / "s", cols, sign=-1, queue_depth=2)
    assert stats.ticks == 4 and stats.duplicates == 0
    assert _tree(tmp_path / "s") == jax_stores["retract"]


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_journal_continues_across_packages(tmp_path, jax_stores, first):
    """Two ticks by one package, then the whole source by the other:
    the first two are duplicates, and the store equals one package's
    full drain."""
    cols = jax_stores["cols"]
    second = "torch" if first == "jax" else "jax"
    _drain(first, tmp_path / "s", cols, max_ticks=2)
    stats = _drain(second, tmp_path / "s", cols, compact_every=2,
                   retention=4)
    assert stats.ticks == 4 and stats.duplicates == 2
    whole = tmp_path / "whole"
    _drain("torch", whole, cols, max_ticks=2)
    _drain("torch", whole, cols, compact_every=2, retention=4)
    assert _tree(tmp_path / "s") == _tree(whole)


def test_weighted_geometric_drain_equal_jax(tmp_path):
    cols = _cols(600, seed=9, weighted=True)
    kw = {"weighted": True, "pad_bucketing": "geometric"}
    _drain("torch", tmp_path / "t", cols, cfg_kw=kw, queue_depth=2)
    _drain("jax", tmp_path / "j", cols, cfg_kw=kw)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def test_crash_mid_tick_heals_byte_identical(tmp_path):
    """A storm at journal.append past the retry budget kills tick 1
    after its artifact is written; the re-run sweeps the orphan,
    re-journals the batch and ends byte-identical to the JAX package's
    clean drain, every batch applied once."""
    cols = _cols(600, seed=6)
    root = tmp_path / "crash"
    _drain("torch", root, cols, micro_batch=200, max_ticks=1)
    faults.install_spec("seed=3,scale=0,journal.append=99")
    with pytest.raises(faults.InjectedFault):
        _drain("torch", root, cols, micro_batch=200)
    faults.install(None)
    assert len(delta.live_entries(str(root))) == 1
    stats = _drain("torch", root, cols, micro_batch=200)
    assert stats.ticks == 3 and stats.duplicates == 1
    live = delta.live_entries(str(root))
    assert len({e["content_hash"] for e in live}) == len(live) == 3
    _drain("jax", tmp_path / "clean", cols, micro_batch=200)
    got, want = _tree(root), _tree(tmp_path / "clean")
    # The crashed tick's orphan sits in quarantine; the store proper
    # (journal, artifacts, CURRENT) equals the clean drain's.
    assert {k: v for k, v in got.items()
            if not k.startswith("quarantine")} == want


# -- the reference's loop properties -----------------------------------------


def test_watermark_monotonic_under_out_of_order_batches(tmp_path):
    cols = _cols(300, seed=3, t0=2.0e9)
    order = np.argsort([-t for t in cols["timestamp"]])
    cols = {k: [v[i] for i in order] for k, v in cols.items()}
    cols["latitude"] = np.asarray(cols["latitude"])
    cols["longitude"] = np.asarray(cols["longitude"])
    seen = []
    events_mod._observer = seen.append
    stats = _drain("torch", tmp_path / "s", cols, micro_batch=75,
                   queue_depth=2)
    assert stats.ticks == 4
    marks = [r["watermark"] for r in seen if r["event"] == "ingest_tick"]
    assert len(marks) == 4 and marks == sorted(marks)
    assert marks[0] == marks[-1] == max(cols["timestamp"])
    assert stats.watermark == max(float(t) for t in cols["timestamp"])


def test_backpressure_bounds_source_readahead(tmp_path):
    """A slow tick blocks the reader: the source never runs more than
    queue depth + feed depth + the items in hand ahead of the ticks."""
    cols = _cols(1200, seed=8)
    produced, applied, worst = [0], [0], [0]

    class Counting(ColumnsSource):
        def batches(self, batch_size=1 << 20):
            for b in super().batches(batch_size):
                produced[0] += 1
                yield b

    real = delta.apply_batch

    def slow_apply(*a, **kw):
        threading.Event().wait(0.05)
        res = real(*a, **kw)
        applied[0] += 1
        worst[0] = max(worst[0], produced[0] - applied[0])
        return res

    delta.apply_batch = slow_apply
    try:
        stats = ingest.run_ingest(
            str(tmp_path / "s"), Counting(cols), _cfg("torch"),
            ingest=ingest.IngestConfig(micro_batch=100, queue_depth=2,
                                       compact_every=0, feed_depth=1),
            device="cpu")
    finally:
        delta.apply_batch = real
    assert stats.ticks == 12
    assert stats.max_queue_depth <= 2
    # depth 2 queued + 1 in the producer's put + 1 fed + 1 in the worker
    assert worst[0] <= 2 + 1 + 1 + 1


def test_redrain_is_idempotent(tmp_path, jax_stores):
    cols = jax_stores["cols"]
    root = tmp_path / "s"
    _drain("torch", root, cols, compact_every=2, retention=4)
    before = _tree(root)
    replay = _drain("torch", root, cols, queue_depth=2)
    assert replay.duplicates == replay.ticks == 4
    assert replay.epochs == [] and replay.points == 0
    assert _tree(root) == before


def test_tick_site_faults_absorbed_by_retry(tmp_path):
    cols = _cols(300, seed=7)
    faults.install_spec("seed=5,scale=0,ingest.tick=2x2")
    stats = _drain("torch", tmp_path / "s", cols, micro_batch=150)
    injected = faults.get_plane().injected
    faults.install(None)
    assert stats.ticks == 2 and stats.duplicates == 0
    assert len(stats.epochs) == 2 and injected == 2


@pytest.mark.parametrize("kw,match", [
    ({"micro_batch": 0}, "micro_batch"),
    ({"sign": 2}, "sign"),
    ({"compact_every": -1}, "compaction thresholds"),
    ({"compact_max_age_s": -1.0}, "compaction thresholds"),
    ({"feed_depth": -1}, "feed_depth"),
])
def test_ingest_config_validation_equal_jax(kw, match):
    for mod in (ingest, jingest):
        with pytest.raises(ValueError, match=match):
            mod.IngestConfig(**kw)


def test_ingest_config_fields_equal_jax():
    import dataclasses

    assert ([f.name for f in dataclasses.fields(ingest.IngestConfig)]
            == [f.name for f in dataclasses.fields(jingest.IngestConfig)])
    assert ([f.name for f in dataclasses.fields(ingest.IngestStats)]
            == [f.name for f in dataclasses.fields(jingest.IngestStats)])


def test_age_triggered_compaction(tmp_path):
    cols = _cols(500, seed=12)
    stats = _drain("torch", tmp_path / "s", cols, compact_max_age_s=1e-9)
    assert stats.compactions == stats.ticks == 2
    assert delta.live_entries(str(tmp_path / "s")) == []


def test_ingest_publishes_ticks_and_refuses_a_temporal_roll(tmp_path):
    """A store and cache take every applied tick's publish. On a store
    that pins a temporal config (ported since: temporal/) each tick's
    window roll drops exactly the retiring buckets' window tiles, the
    count and the store of the JAX loop over the same ticks."""
    from heatmap_tpu.serve import ServeApp as JServeApp
    from heatmap_tpu.serve import TileCache as JTileCache
    from heatmap_tpu.serve import TileStore as JTileStore
    from heatmap_tpu_torch.delta.compact import read_current, write_current
    from heatmap_tpu_torch.serve import ServeApp, TileCache, TileStore

    root = str(tmp_path / "s")
    delta.apply_batch(root, ColumnsSource(_cols(300)), _cfg("torch"),
                      device="cpu")
    from heatmap_tpu_torch.tilemath.keys import (parse_tile_id,
                                                 tile_id_from_lat_long)

    app = ServeApp(TileStore(f"delta:{root}"), TileCache())
    for z in range(5):
        _, y, x = parse_tile_id(tile_id_from_lat_long(37.1, -122.1, z))
        for fmt in ("png", "json"):
            assert app.handle("GET", f"/tiles/default/{z}/{x}/{y}.{fmt}"
                              )[0] == 200
    stats = ingest.run_ingest(root, ColumnsSource(_cols(600, seed=4)),
                              _cfg("torch"), device="cpu",
                              ingest=ingest.IngestConfig(
                                  micro_batch=300, queue_depth=None),
                              store=app.store, cache=app.cache)
    assert stats.ticks == 2 and stats.keys_invalidated == 10
    jroot = str(tmp_path / "j")
    jingest.run_ingest(jroot, JColumnsSource(_cols(300)), _cfg("jax"),
                       ingest=jingest.IngestConfig(micro_batch=300,
                                                   queue_depth=None))
    jingest.run_ingest(jroot, JColumnsSource(_cols(600, seed=4)),
                       _cfg("jax"), ingest=jingest.IngestConfig(
                           micro_batch=300, queue_depth=None))
    japp = JServeApp(JTileStore(f"delta:{jroot}"), JTileCache())
    tiles = []
    for z in range(5):
        _, y, x = parse_tile_id(tile_id_from_lat_long(37.1, -122.1, z))
        tiles.append(f"/tiles/default/{z}/{x}/{y}.json?window=60")
    counts = []
    for r, a, run, src in ((root, app, ingest.run_ingest, ColumnsSource),
                           (jroot, japp, jingest.run_ingest,
                            JColumnsSource)):
        write_current(r, {**read_current(r), "temporal": {"width": 60}})
        a.store.reload()
        for t in tiles:
            assert a.handle("GET", t)[0] == 200
        kw = {"device": "cpu"} if a is app else {}
        mod = ingest if a is app else jingest
        st = run(r, src(_cols(300, seed=5, t0=1.5e9 + 700)),
                 _cfg("torch" if a is app else "jax"),
                 ingest=mod.IngestConfig(micro_batch=100, queue_depth=None),
                 store=a.store, cache=a.cache, **kw)
        counts.append((st.ticks, st.keys_invalidated))
    assert counts[0] == counts[1]
    assert counts[0][1] > 0
    assert _tree(root) == _tree(jroot)


def test_ingest_needs_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ingest.run_ingest(str(tmp_path / "s"), ColumnsSource(_cols(10)))


def test_ingest_tick_feeds_staleness_slo():
    engine = slo.SLOEngine([slo.SLOSpec("fresh", "staleness",
                                        max_age_s=60.0)])
    slo.set_engine(engine)
    obs.emit("ingest_tick", tick=0, points=10, seconds=0.01)
    (objective,) = engine.status()["objectives"]
    assert objective["name"] == "fresh" and objective["compliance"] == 1.0
    assert not objective["breaching"]
    later = engine.status(now=time.time() + 120.0)
    assert later["breaching"] == ["fresh"]


def test_loop_ticks_feed_staleness_slo(tmp_path):
    engine = slo.SLOEngine([slo.SLOSpec("fresh", "staleness",
                                        max_age_s=30.0)])
    slo.set_engine(engine)
    _drain("torch", tmp_path / "s", _cols(300, seed=2))
    status = engine.status()
    assert status["ok"] and status["objectives"][0]["good"] >= 1


# -- host bytes for the hash, fed tensors for the cascade --------------------


def test_hash_reads_host_bytes_and_cascade_reads_fed_tensors(
        tmp_path, monkeypatch):
    """A CUDA-free stand-in for the feeder's transfer hands the tick a
    FedColumns: the journal's content hash is the unfed drain's (it
    reads the host columns), the cascade projects the fed tensors
    themselves (no copy), and the store is byte-identical."""
    cols = _cols(500, seed=11)
    fed_tensors = []

    def stand_in(batch):
        idx = tbatch.kept_rows(batch)
        dev = {}
        for name in ("latitude", "longitude"):
            col = np.asarray(batch[name], np.float64)
            dev[name] = torch.as_tensor(col if idx is None else col[idx])
        fed_tensors.append(dev["latitude"])
        return feeder_mod.FedColumns(batch, dev)

    projected = []
    real_project = tbatch.project_codes

    def spy(lat, lon, *a, **kw):
        projected.append(lat)
        return real_project(lat, lon, *a, **kw)

    monkeypatch.setattr(loop_mod, "_identity", stand_in)
    monkeypatch.setattr(tbatch, "project_codes", spy)
    _drain("torch", tmp_path / "fed", cols, feed_depth=1)
    monkeypatch.undo()
    assert len(fed_tensors) == 2 and len(projected) == 2
    assert all(p is f for p, f in zip(projected, fed_tensors))
    _drain("torch", tmp_path / "plain", cols, feed_depth=0)
    assert _tree(tmp_path / "fed") == _tree(tmp_path / "plain")
    hashes = [e["content_hash"]
              for e in delta.live_entries(str(tmp_path / "fed"))]
    want = [batch_content_hash(delta.read_columns(ColumnsSource(
        {k: v[lo:lo + 250] for k, v in cols.items()})))
        for lo in (0, 250)]
    assert hashes == want


def test_fed_columns_are_checked_against_the_batch(tmp_path):
    cols = _cols(100, seed=1)
    bad = {"latitude": torch.zeros(3, dtype=torch.float64)}
    with pytest.raises(ValueError, match="does not match the batch"):
        delta.apply_batch(str(tmp_path / "s"), ColumnsSource(cols),
                          _cfg("torch"), device="cpu", device_columns=bad)


# -- the ingest command ------------------------------------------------------


def _ingest_argv(root, *extra):
    return ["ingest", "--journal", str(root), "--input", "synthetic:3000:5",
            "--detail-zoom", "10", "--micro-batch", "700",
            "--compact-every", "3", *extra]


@pytest.mark.parametrize("extra", [[], ["--pad-bucketing", "geometric",
                                        "--queue-depth", "0"]])
def test_ingest_command_equal_jax(tmp_path, capsys, extra):
    """``ingest`` prints the JAX summary's keys (then ``device``) with
    the same values, compile_cache included, and writes the same store."""
    assert tcli.main([*_ingest_argv(tmp_path / "t", *extra),
                      "--backend", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jbucketing.reset_cache_stats()
    assert jcli.main([*_ingest_argv(tmp_path / "j", *extra),
                      "--backend", "cpu"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == [*want, "device"] and got["device"] == "cpu"
    # With a queue, max_queue_depth is the reader thread's high-water
    # mark, which varies from run to run in either package; run_ticks
    # bounds it by the queue's depth plus the tick in hand.
    queued = "--queue-depth" not in extra
    for k in want:
        if k in ("journal", "seconds"):
            continue
        if k == "max_queue_depth" and queued:
            for v in (got[k], want[k]):
                assert 1 <= v <= 4 + 1, (k, v)
            continue
        assert got[k] == want[k], k
    assert got["compactions"] == 1 and got["ticks"] == 5
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def test_ingest_command_retract(tmp_path, capsys):
    root = tmp_path / "s"
    tcli.main([*_ingest_argv(root), "--backend", "cpu"])
    tcli.main([*_ingest_argv(root), "--backend", "cpu", "--retract"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ticks"] == 5 and out["duplicates"] == 0


def test_ingest_command_telemetry_keeps_the_store(tmp_path, capsys):
    """Every telemetry flag on: valid events with ingest_tick, the
    ingest and bucket series, the report's slo section, the spill; the
    store equals the drain without telemetry."""
    tel = tmp_path / "tel"
    tel.mkdir()
    assert tcli.main([
        *_ingest_argv(tmp_path / "on"), "--backend", "cpu",
        "--events", str(tel / "events.jsonl"), "--metrics-dir", str(tel),
        "--report", str(tel / "run_report.json"),
        "--slo", "fresh:staleness:max_age_s=30",
        "--incident-dir", str(tel / "incidents"),
        "--flight-recorder-spans", "256", "--tail-latency-ms", "1",
        "--telemetry-sample-interval", "0.05",
        "--watch", "ingest_lag_seconds:z=6"]) == 0
    assert tcli.main([*_ingest_argv(tmp_path / "off"), "--backend",
                      "cpu"]) == 0
    capsys.readouterr()
    recs = obs.read_events(str(tel / "events.jsonl"))
    for r in recs:
        obs.validate_event(r)
    kinds = [r["event"] for r in recs]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("ingest_tick") == 5
    prom = (tel / "metrics.prom").read_text()
    for series in ("ingest_ticks_total", "ingest_lag_seconds",
                   "cascade_bucket_misses_total",
                   "cascade_pad_emissions_total"):
        assert series in prom, series
    report = json.loads((tel / "run_report.json").read_text())
    assert report["slo"]["objectives"][0]["name"] == "fresh"
    assert any(p.name.startswith("snap-")
               for p in (tel / "incidents" / "telemetry").iterdir())
    assert _tree(tmp_path / "on") == _tree(tmp_path / "off")
    # The command leaves obs as it found it.
    assert slo.get_engine() is None and obs.recorder.get_recorder() is None
    assert obs.timeseries.get_store() is None
    assert obs.incident.get_manager() is None


@pytest.mark.parametrize("flag,value,item", [
    ("--bucket-width", "3600", 5),
    ("--bucket-fanout", "4", 5),
    ("--bucket-keep", "8", 5),
    ("--bucket-tiers", "4", 5),
    ("--bucket-unit-s", "1", 5),
    ("--data-parallel", "on", 7),
    ("--dispatch", "gspmd", 7),
    ("--dispatch", "shard_map", 7),
])
def test_ingest_unported_flags_refused(capsys, flag, value, item):
    """Values that need ``parallel/`` (item 7) exit 2 at parse time; the
    ``--bucket-*`` flags (temporal/, ported) parse to the JAX
    parser's values."""
    if item == 5:
        argv = ["ingest", "--journal", "R", "--input", "synthetic:10", flag,
                value]
        dest = flag[2:].replace("-", "_")
        assert (getattr(tcli.build_parser().parse_args(argv), dest)
                == getattr(jcli.build_parser().parse_args(argv), dest)
                == float(value))
        return
    with pytest.raises(SystemExit) as exc:
        tcli.build_parser().parse_args(
            ["ingest", "--journal", "R", "--input", "synthetic:10", flag,
             value])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"item {item}" in err and flag in err


def test_ingest_flags_equal_jax():
    """Every flag of the JAX ``ingest`` parses in the port's (the port
    adds its backend alias ``--device``)."""
    def flags(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {o for a in sub.choices["ingest"]._actions
                for o in a.option_strings}

    jflags, tflags = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert jflags <= tflags
    assert tflags - jflags == {"--device"}
