"""The port's write plane (heatmap_tpu_torch.writeplane) against the JAX
package's (heatmap_tpu.writeplane) on the CPU.

Each case of tests/test_writeplane.py runs here on both planes over the
same seeded batches: routing is a disjoint union and equal to the JAX
router's; a 4-writer plane with a mid-run re-split, a retraction, a
duplicate and per-range compaction serves the JAX plane's docs, which
equal a single-writer store's; the plane roots themselves are equal (the
journal and ledger entries up to their wall-clock ``ts``); pumped drains
of 2 and 4 writers and bucketed padding give the single-writer docs; a
torn manifest falls back and is quarantined, an orphan range is
quarantined, a writer killed mid-apply heals, a replay after a re-split
dedups, a restart adopts the plan (a JAX-written one too); every refusal
reads as the JAX one; ledger records from many threads lose no entry;
and a plane root written by either package mounts in the other's
``TileStore`` with equal answers. The port runs with ``device="cpu"``.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import threading
import types

import numpy as np
import pytest

from heatmap_tpu import delta as jdelta
from heatmap_tpu import faults as jfaults
from heatmap_tpu import writeplane as jwp
from heatmap_tpu.delta.compute import read_columns as jread_columns
from heatmap_tpu.io import open_source as jopen_source
from heatmap_tpu.pipeline import BatchJobConfig as JConfig
from heatmap_tpu.serve import ServeApp as JApp
from heatmap_tpu.serve import TileCache as JCache
from heatmap_tpu.serve import TileStore as JStore
from heatmap_tpu.serve.render import tile_json_bytes as jtile_json
from heatmap_tpu.writeplane import manifest as jmanifest
from heatmap_tpu_torch import _build
from heatmap_tpu_torch import delta as tdelta
from heatmap_tpu_torch import faults as tfaults
from heatmap_tpu_torch import writeplane as twp
from heatmap_tpu_torch.delta import recover as trecover
from heatmap_tpu_torch.delta.compute import read_columns as tread_columns
from heatmap_tpu_torch.io import open_source as topen_source
from heatmap_tpu_torch.io.merge import merge_level_dirs
from heatmap_tpu_torch.pipeline.batch import BatchJobConfig as TConfig
from heatmap_tpu_torch.serve import ServeApp as TApp
from heatmap_tpu_torch.serve import TileCache as TCache
from heatmap_tpu_torch.serve import TileStore as TStore
from heatmap_tpu_torch.serve.render import tile_json_bytes as ttile_json
from heatmap_tpu_torch.tilemath.morton import morton_decode_np
from heatmap_tpu_torch.utils.checkpoint import load_checkpoint
from heatmap_tpu_torch.writeplane import manifest as tmanifest
from heatmap_tpu_torch.writeplane import pumps as tpumps

BASE_SPEC = "synthetic:600:7"
DELTA_SPEC = "synthetic:400:11"
RETRACT_ROWS = 150  # first N base rows get retracted

CONFIG = dict(detail_zoom=8, min_detail_zoom=6, result_delta=2)

JAX = types.SimpleNamespace(
    name="jax", wp=jwp, manifest=jmanifest, Config=JConfig, Store=JStore,
    tile_json=jtile_json, open_source=jopen_source, faults=jfaults,
    read_columns=jread_columns, kw={},
    apply=lambda root, src, config, **k: jdelta.apply_batch(
        root, src, config, **k))
TORCH = types.SimpleNamespace(
    name="torch", wp=twp, manifest=tmanifest, Config=TConfig, Store=TStore,
    tile_json=ttile_json, open_source=topen_source, faults=tfaults,
    read_columns=tread_columns, kw={"device": "cpu"},
    apply=lambda root, src, config, **k: tdelta.apply_batch(
        root, src, config, device="cpu", **k))
BOTH = (JAX, TORCH)


@pytest.fixture(autouse=True)
def _clear_sweep_cache():
    yield
    trecover.clear_verified_cache()


def _plane(pkg, root, config=None, **plane_kw):
    return pkg.wp.WritePlane(str(root), config or pkg.Config(**CONFIG),
                             pkg.wp.PlaneConfig(**plane_kw), **pkg.kw)


def _collect_docs(pkg, store) -> dict:
    """Every servable JSON tile of every layer: {(layer, z, x, y): bytes}."""
    docs = {}
    for name, layer in store.layers.items():
        if name == "default":  # alias of all|alltime, not a new layer
            continue
        shift = 2 * layer.result_delta
        for want, level in layer.levels.items():
            z = want - layer.result_delta
            if z < 0:
                continue
            rows, cols = morton_decode_np(
                np.unique(np.asarray(level.codes) >> shift))
            for r, c in zip(rows, cols):
                docs[(name, z, int(c), int(r))] = pkg.tile_json(
                    layer, z, int(c), int(r))
    return docs


def _docs(pkg, spec):
    return _collect_docs(pkg, pkg.Store(str(spec)))


def _levels(root):
    """The merged level arrays a reader of the newest manifest sees."""
    from heatmap_tpu_torch.delta.compact import drop_zero_rows

    snap = tmanifest.read_manifest(str(root))
    dirs = tmanifest.overlay_dirs(str(root), snap)
    return drop_zero_rows(merge_level_dirs(dirs))


def _same_levels(a, b):
    assert [int(x["zoom"]) for x in a] == [int(x["zoom"]) for x in b]
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]),
                                          err_msg=f"z{x['zoom']} {k}")


def _tree(root):
    """Every file under a plane root; journal and ledger entries as their
    meta without the wall-clock ``ts`` and their arrays."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.startswith("ckpt-") and f.endswith(".npz"):
                arrays, meta = load_checkpoint(path)
                meta.pop("ts", None)
                out[rel] = (json.dumps(meta, sort_keys=True),
                            {k: v.tolist() for k, v in arrays.items()})
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def _slice_cols(cols: dict, sl: slice) -> dict:
    return {k: v[sl] for k, v in cols.items()}


def _single_writer_docs(pkg, root, spec=BASE_SPEC, micro=200, config=None):
    config = config or pkg.Config(**CONFIG)
    for batch in pkg.open_source(spec).batches(micro):
        pkg.apply(str(root), tdelta.ColumnsSource(batch)
                  if pkg is TORCH else jdelta.ColumnsSource(batch), config)
    return _docs(pkg, f"delta:{root}")


def _run_scenario(pkg, tmp):
    """The JAX test's scenario on one package: 4 writers, a forced
    re-split of r000 after the first batch, a second batch, a retraction,
    a duplicate re-submit, and per-range compaction."""
    b1 = pkg.read_columns(pkg.open_source(BASE_SPEC))
    b2 = pkg.read_columns(pkg.open_source(DELTA_SPEC))
    retract = _slice_cols(b1, slice(0, RETRACT_ROWS))
    proot = str(tmp / "plane")
    plane = _plane(pkg, proot, n_writers=4)
    out = {"b1": b1, "b2": b2, "proot": proot, "plane": plane}
    out["r1"] = plane.append_columns(b1)
    out["rebalance"] = plane.rebalance(force_range="r000", reason="test")
    out["r2"] = plane.append_columns(b2)
    out["r3"] = plane.append_columns(retract, sign=-1)
    plane.publish()
    out["docs_before"] = _docs(pkg, proot)
    out["levels_before"] = _levels(proot)
    out["r2_dup"] = plane.append_columns(b2)
    plane.publish()
    out["docs_after_dup"] = _docs(pkg, proot)
    for name in plane.order:
        plane.compact_range(name)
    out["docs_after_compact"] = _docs(pkg, proot)
    out["levels_after_compact"] = _levels(proot)
    out["tree"] = _tree(proot)
    return out


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    out = {p.name: _run_scenario(p, tmp_path_factory.mktemp(f"wp_{p.name}"))
           for p in BOTH}
    # The single-writer reference, fed the identical batches.
    config = TConfig(**CONFIG)
    sroot = str(tmp_path_factory.mktemp("wp_single") / "store")
    t = out["torch"]
    tdelta.apply_batch(sroot, tdelta.ColumnsSource(t["b1"]), config,
                       device="cpu")
    tdelta.apply_batch(sroot, tdelta.ColumnsSource(t["b2"]), config,
                       device="cpu")
    tdelta.apply_batch(sroot, tdelta.ColumnsSource(
        _slice_cols(t["b1"], slice(0, RETRACT_ROWS))), config, sign=-1,
        device="cpu")
    out["sroot"] = sroot
    out["docs_ref"] = _docs(TORCH, f"delta:{sroot}")
    out["config"] = config
    return out


class TestRouting:
    def test_route_is_a_disjoint_union(self, scenario):
        t, j = scenario["torch"], scenario["jax"]
        parts = t["plane"].route(t["b1"])
        total = sum(len(sub["latitude"]) for _, sub in parts)
        assert total == len(t["b1"]["latitude"])
        names = [name for name, _ in parts]
        assert len(names) == len(set(names))
        want = j["plane"].route(j["b1"])
        assert names == [name for name, _ in want]
        for (_, a), (_, b) in zip(parts, want):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]))

    def test_route_is_deterministic(self, scenario):
        plane, b1 = scenario["torch"]["plane"], scenario["torch"]["b1"]
        first = plane.route(b1)
        second = plane.route(b1)
        assert [n for n, _ in first] == [n for n, _ in second]
        for (_, a), (_, b) in zip(first, second):
            np.testing.assert_array_equal(a["latitude"], b["latitude"])

    def test_batches_straddle_range_boundaries(self, scenario):
        for pkg in BOTH:
            s = scenario[pkg.name]
            assert len(s["r1"].results) >= 2
            assert len(s["r2"].results) >= 2
        assert (sorted(scenario["torch"]["r1"].results)
                == sorted(scenario["jax"]["r1"].results))

    def test_route_requires_a_plan(self, tmp_path):
        msgs = []
        for pkg in BOTH:
            plane = _plane(pkg, tmp_path / pkg.name, n_writers=2)
            with pytest.raises(ValueError, match="no partition plan") as e:
                plane.route({"latitude": np.zeros(1),
                             "longitude": np.zeros(1)})
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


class TestByteIdentity:
    def test_four_writers_with_rebalance_and_retraction(self, scenario):
        """4 writers + a mid-run re-split + a retraction serve the JAX
        plane's docs, and those equal one writer's."""
        t, j = scenario["torch"], scenario["jax"]
        assert t["rebalance"] is not None
        assert len(scenario["docs_ref"]) > 50  # non-trivial pyramid
        assert t["docs_before"] == j["docs_before"] == scenario["docs_ref"]
        _same_levels(t["levels_before"], j["levels_before"])
        assert ({k: t["rebalance"][k] for k in ("range", "new_range",
                                                "split", "epoch")}
                == {k: j["rebalance"][k] for k in ("range", "new_range",
                                                   "split", "epoch")})
        for r in ("r1", "r2", "r3"):
            assert t[r].points == j[r].points
            assert t[r].content_hash == j[r].content_hash
            assert t[r].affected_keys == j[r].affected_keys

    def test_duplicate_resubmit_changes_nothing(self, scenario):
        for pkg in BOTH:
            s = scenario[pkg.name]
            assert s["r2_dup"].duplicate
            assert s["docs_after_dup"] == scenario["docs_ref"]

    def test_identity_survives_per_range_compaction(self, scenario):
        t, j = scenario["torch"], scenario["jax"]
        assert t["docs_after_compact"] == j["docs_after_compact"] \
            == scenario["docs_ref"]
        _same_levels(t["levels_after_compact"], j["levels_after_compact"])

    def test_plane_root_equals_the_jax_root(self, scenario):
        """Manifests, range stores and ledger: the same files with the
        same bytes (journal entries up to their wall-clock ``ts``)."""
        t, j = scenario["torch"]["tree"], scenario["jax"]["tree"]
        assert sorted(t) == sorted(j)
        for rel in t:
            assert t[rel] == j[rel], rel

    @pytest.mark.parametrize("writers", [2, 4])
    def test_pumped_writers_match_single_writer(self, tmp_path, writers):
        """A pumped N-writer drain over micro-batches serves the docs of a
        single-writer store fed the same micro-batches, and the JAX
        pumps' docs and counts."""
        ref = _single_writer_docs(TORCH, tmp_path / "single")
        got = {}
        for pkg in BOTH:
            proot = tmp_path / f"plane_{pkg.name}"
            plane = _plane(pkg, proot, n_writers=writers)
            stats = pkg.wp.run_plane_ingest(plane, pkg.open_source(BASE_SPEC),
                                            micro_batch=200)
            assert stats.failed == 0
            assert stats.completed == stats.batches == 3
            got[pkg.name] = (_docs(pkg, proot), stats.points,
                             plane.order, plane.splits)
        assert got["torch"][0] == got["jax"][0] == ref
        assert got["torch"][1:] == got["jax"][1:]

    def test_bucketed_padding_is_byte_neutral(self, tmp_path):
        """pow2 padding pads each routed sub-batch with NaN lat/lon lanes
        (masked invalid): the overlay must not notice, and the points
        count real rows only."""
        ref = _single_writer_docs(TORCH, tmp_path / "single")
        for pkg in BOTH:
            config = pkg.Config(**CONFIG, pad_bucketing="pow2",
                                pad_bucket_min=1 << 7)
            proot = tmp_path / f"plane_{pkg.name}"
            plane = _plane(pkg, proot, config, n_writers=3)
            stats = pkg.wp.run_plane_ingest(plane, pkg.open_source(BASE_SPEC),
                                            micro_batch=200)
            assert stats.failed == 0
            assert stats.points == 600  # real rows, not pad lanes
            assert _docs(pkg, proot) == ref

    def test_pad_cols_is_the_jax_pad(self, scenario):
        from heatmap_tpu.writeplane.plane import _pad_cols as jpad
        from heatmap_tpu_torch.writeplane.plane import _pad_cols as tpad

        cols = _slice_cols(scenario["torch"]["b1"], slice(0, 37))
        for target in (10, 37, 64):
            a, b = tpad(cols, target), jpad(cols, target)
            assert list(a) == list(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]))
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


class TestManifest:
    def test_snapshots_are_digest_stamped(self, scenario):
        t, j = scenario["torch"]["proot"], scenario["jax"]["proot"]
        epoch = twp.read_pointer(t)
        assert epoch == jwp.read_pointer(j)
        snap = twp.load_snapshot(t, epoch)
        assert snap["epoch"] == epoch
        assert snap["digest"].startswith("sha256:")
        assert snap == jwp.load_snapshot(j, epoch)

    def test_overlay_never_mixes_epochs(self, scenario):
        proot = scenario["torch"]["proot"]
        epochs = tmanifest.list_epochs(proot)
        assert len(epochs) >= 2
        old = twp.load_snapshot(proot, epochs[-2])
        for d in twp.overlay_dirs(proot, old):
            rel = os.path.relpath(d, proot)
            parts = rel.split(os.sep)  # ranges/rNNN/<artifact>
            entry = old["ranges"][parts[1]]
            assert parts[2] in ([entry["base"]] + list(entry["deltas"]))

    def test_torn_manifest_falls_back_and_quarantines(self, scenario,
                                                      tmp_path):
        out = {}
        for pkg in BOTH:
            s = scenario[pkg.name]
            proot = str(tmp_path / pkg.name)
            plane = _plane(pkg, proot, n_writers=2)
            plane.append_columns(s["b1"])
            plane.publish()
            good_docs = _docs(pkg, proot)
            good_epoch = pkg.wp.read_pointer(proot)
            plane.append_columns(s["b2"])
            plane.publish()
            torn = pkg.manifest.manifest_path(proot,
                                              pkg.wp.read_pointer(proot))
            with open(torn, "w") as f:
                f.write('{"epoch": tru')  # torn mid-write
            assert _docs(pkg, proot) == good_docs
            res = pkg.wp.sweep_plane(proot)
            reasons = [q["reason"] for q in res["quarantined"]]
            assert "torn_manifest" in reasons
            assert not os.path.exists(torn)
            assert pkg.wp.read_pointer(proot) == good_epoch
            assert _docs(pkg, proot) == good_docs
            out[pkg.name] = (reasons, good_epoch, good_docs)
        assert out["torch"] == out["jax"]

    def test_orphan_range_is_quarantined(self, scenario, tmp_path):
        out = {}
        for pkg in BOTH:
            proot = str(tmp_path / pkg.name)
            plane = _plane(pkg, proot, n_writers=2)
            plane.append_columns(scenario[pkg.name]["b1"])
            plane.publish()
            orphan = os.path.join(proot, "ranges", "r099")
            os.makedirs(orphan)
            res = pkg.wp.sweep_plane(proot)
            out[pkg.name] = [(q["reason"], q["kind"])
                             for q in res["quarantined"]]
            assert ("orphan_range", "range") in out[pkg.name]
            assert not os.path.exists(orphan)
        assert out["torch"] == out["jax"]

    def test_manifest_history_is_bounded(self, scenario):
        proot = scenario["torch"]["proot"]
        plane = scenario["torch"]["plane"]
        n = len(glob.glob(os.path.join(proot, "manifest-*.json")))
        assert n <= plane.plane.manifest_keep


class TestExactlyOnce:
    def test_writer_killed_mid_apply_heals_on_restart(self, tmp_path):
        """Kill one of three writers mid-run: survivors keep applying and
        publishing; re-running the stream after a restart heals to the
        single-writer docs, as in the JAX package."""
        ref = _single_writer_docs(TORCH, tmp_path / "single")
        victim = "r001"
        for pkg in BOTH:
            proot = str(tmp_path / pkg.name)
            plane = _plane(pkg, proot, n_writers=3)
            pkg.faults.install_spec(f"scale=0,writeplane.append@{victim}=99")
            try:
                stats = pkg.wp.run_plane_ingest(
                    plane, pkg.open_source(BASE_SPEC), micro_batch=200)
            finally:
                pkg.faults.install(None)
            assert stats.pumps[victim].dead
            assert stats.failed > 0
            assert stats.epoch > 1
            survivors = [n for n in plane.order if n != victim]
            assert any(stats.pumps[n].applied for n in survivors)
            plane2 = _plane(pkg, proot, n_writers=3)
            stats2 = pkg.wp.run_plane_ingest(
                plane2, pkg.open_source(BASE_SPEC), micro_batch=200)
            assert stats2.failed == 0
            assert _docs(pkg, proot) == ref

    def test_partial_apply_replays_as_jax(self, scenario, tmp_path):
        """A crash after one range applied its part of a batch (before
        the ledger record): the replay deduplicates that range's part,
        applies the rest, and reports what the JAX plane reports."""
        out = {}
        for pkg in BOTH:
            s = scenario[pkg.name]
            proot = str(tmp_path / pkg.name)
            plane = _plane(pkg, proot, n_writers=3)
            plane.ensure_plan(s["b1"])
            name, sub = plane.route(s["b1"])[1]
            plane.apply_range(name, sub)
            res = plane.append_columns(s["b1"])
            plane.publish()
            assert not res.duplicate and res.results[name].duplicate
            out[pkg.name] = (
                {n: (r.duplicate, r.points) for n, r in res.results.items()},
                set(res.affected_keys), _docs(pkg, proot))
        assert out["torch"] == out["jax"]
        sroot = str(tmp_path / "single")
        tdelta.apply_batch(sroot, tdelta.ColumnsSource(
            scenario["torch"]["b1"]), scenario["config"], device="cpu")
        assert out["torch"][2] == _docs(TORCH, f"delta:{sroot}")

    def test_replay_after_resplit_still_dedups(self, tmp_path):
        for pkg in BOTH:
            proot = str(tmp_path / pkg.name)
            plane = _plane(pkg, proot, n_writers=2)
            pkg.wp.run_plane_ingest(plane, pkg.open_source(BASE_SPEC),
                                    micro_batch=200)
            before = _docs(pkg, proot)
            plane2 = _plane(pkg, proot, n_writers=2)
            assert plane2.rebalance(force_range="r000") is not None
            stats = pkg.wp.run_plane_ingest(
                plane2, pkg.open_source(BASE_SPEC), micro_batch=200)
            assert stats.duplicates == stats.batches
            assert _docs(pkg, proot) == before

    def test_restart_adopts_the_persisted_plan(self, scenario, tmp_path):
        """The port adopts its own persisted plan and the JAX package's."""
        for writer in BOTH:
            proot = str(tmp_path / writer.name)
            plane = _plane(writer, proot, n_writers=3)
            plane.append_columns(scenario[writer.name]["b1"])
            plane.publish()
            plane2 = _plane(TORCH, proot, n_writers=3)
            assert plane2.planned
            assert plane2.splits == plane.splits
            assert plane2.order == plane.order
            assert plane2.epoch == plane.epoch

    def test_config_mismatch_is_refused(self, scenario, tmp_path):
        msgs = []
        for pkg in BOTH:
            proot = str(tmp_path / pkg.name)
            plane = _plane(pkg, proot, n_writers=2)
            plane.append_columns(scenario[pkg.name]["b1"])
            plane.publish()
            other = pkg.Config(detail_zoom=9, min_detail_zoom=6,
                               result_delta=2)
            with pytest.raises(ValueError, match="detail_zoom") as e:
                _plane(pkg, proot, other, n_writers=2)
            msgs.append(str(e.value).replace(proot, "ROOT"))
        assert msgs[0] == msgs[1]

    def test_sign_refusal_matches_jax(self, scenario, tmp_path):
        msgs = []
        for pkg in BOTH:
            plane = _plane(pkg, tmp_path / pkg.name, n_writers=2)
            with pytest.raises(ValueError) as e:
                plane.append_columns(scenario[pkg.name]["b1"], sign=0)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _refusal_pair(fn, root=None):
    """Both packages refuse ``fn(pkg)`` with one message (``root /
    pkg.name`` read as ROOT)."""
    msgs = []
    for pkg in BOTH:
        with pytest.raises(ValueError) as e:
            fn(pkg)
        msg = str(e.value)
        msgs.append(msg if root is None
                    else msg.replace(str(root / pkg.name), "ROOT"))
    assert msgs[0] == msgs[1]
    return msgs[0]


class TestRetentionFloor:
    def test_compact_below_floor_is_refused(self, scenario):
        msg = _refusal_pair(lambda pkg: scenario[pkg.name]["plane"]
                            .compact_range("r000", retention=1))
        assert "floor" in msg

    def test_compact_below_inflight_depth_is_refused(self, tmp_path):
        def fn(pkg):
            root = str(tmp_path / pkg.name)
            pkg.apply(root, pkg.open_source("synthetic:100:7"),
                      pkg.Config(**CONFIG))
            (tdelta if pkg is TORCH else jdelta).compact(
                root, retention=2, inflight=5)

        msg = _refusal_pair(fn, tmp_path)
        assert "in-flight" in msg

    @pytest.mark.parametrize("kw", [
        dict(n_writers=0), dict(retention_floor=0),
        dict(retention=1, retention_floor=3), dict(ledger_keep=0),
        dict(manifest_keep=0)])
    def test_plane_config_refusals_match_jax(self, kw):
        _refusal_pair(lambda pkg: pkg.wp.PlaneConfig(**kw))

    @pytest.mark.parametrize("kw", [dict(queue_depth=0),
                                    dict(publish_every=0)])
    def test_pump_refusals_match_jax(self, scenario, kw):
        _refusal_pair(lambda pkg: pkg.wp.PlanePumps(
            scenario[pkg.name]["plane"], **kw))

    def test_deep_queue_defers_compaction(self, scenario):
        plane = scenario["torch"]["plane"]
        assert plane.maybe_compact(plane.order[0], inflight=0) is None
        assert plane.maybe_compact(
            plane.order[0], inflight=plane.plane.retention + 1) is None


class TestRebalance:
    def test_resplit_summary_and_lineage(self, scenario):
        for pkg in BOTH:
            rb = scenario[pkg.name]["rebalance"]
            assert rb["range"] == "r000"
            assert rb["new_range"] == "r004"
            snap = pkg.wp.read_manifest(scenario[pkg.name]["proot"])
            assert snap["ranges"][rb["new_range"]]["parent"] == "r000"
            order = snap["order"]
            assert order.index(rb["new_range"]) == order.index("r000") + 1

    def test_balanced_plane_declines_to_split(self, scenario, tmp_path):
        for pkg in BOTH:
            plane = _plane(pkg, tmp_path / pkg.name, n_writers=2,
                           balance_factor=1e9)
            plane.append_columns(scenario[pkg.name]["b1"])
            assert plane.rebalance() is None

    def test_skewed_plane_splits_as_jax(self, scenario, tmp_path):
        """A skew-triggered (not forced) re-split picks the JAX split."""
        out = []
        for pkg in BOTH:
            # At z12 the hot range's mass spreads over many cells, so its
            # weighted median is a real split (at CONFIG's z8 it is not).
            plane = _plane(pkg, tmp_path / pkg.name,
                           pkg.Config(detail_zoom=12, min_detail_zoom=8,
                                      result_delta=2), n_writers=3)
            plane.append_columns(scenario[pkg.name]["b1"])
            # A second batch that lands in one range only skews the plane.
            parts = plane.route(scenario[pkg.name]["b2"])
            plane.append_columns(max(parts, key=lambda p: len(
                p[1]["latitude"]))[1])
            rb = plane.rebalance()
            out.append(None if rb is None else
                       {k: rb[k] for k in ("range", "new_range", "split",
                                           "epoch", "reason")})
        assert out[0] == out[1] and out[0] is not None

    def test_unknown_force_range_is_refused(self, scenario):
        msg = _refusal_pair(lambda pkg: scenario[pkg.name]["plane"]
                            .rebalance(force_range="r999"))
        assert "unknown range" in msg

    def test_rebalance_defers_under_inflight_queue(self, scenario):
        plane = scenario["torch"]["plane"]
        assert plane.rebalance(force_range=plane.order[0],
                               inflight=plane.plane.retention + 1) is None


class TestConcurrency:
    def test_concurrent_ledger_records_never_lose_entries(self, tmp_path):
        plane = _plane(TORCH, tmp_path / "p", n_writers=2, ledger_keep=256)
        hashes = [f"sha256:{i:064x}" for i in range(24)]
        threads = [threading.Thread(target=plane.record_batch, args=(h,),
                                    kwargs=dict(points=1, sign=1))
                   for h in hashes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
        entries = plane._ledger.entries()
        assert sorted(e["content_hash"] for e in entries) == sorted(hashes)
        assert len({e["epoch"] for e in entries}) == len(hashes)

    def test_pump_bookkeeping_failure_fails_fast(self, tmp_path,
                                                 monkeypatch):
        plane = _plane(TORCH, tmp_path / "p", n_writers=2)
        orig = tpumps.PlanePumps._pump_one

        def boom(self, name, q, ps, seq, sub, sign):
            if name == "r000":
                raise KeyError("bookkeeping bug")
            return orig(self, name, q, ps, seq, sub, sign)

        monkeypatch.setattr(tpumps.PlanePumps, "_pump_one", boom)
        stats = tpumps.run_plane_ingest(plane, topen_source(BASE_SPEC),
                                        micro_batch=100)
        assert stats.pumps["r000"].dead
        assert "bookkeeping bug" in stats.pumps["r000"].error
        assert stats.failed > 0
        assert stats.batches == 6  # the whole stream drained — no hang

    def test_double_completed_part_is_a_noop(self, tmp_path):
        plane = _plane(TORCH, tmp_path / "p")
        pumps = tpumps.PlanePumps(plane)
        pumps._part_done(999, ok=False)  # unknown seq: no KeyError
        assert pumps.stats.failed == 0

    def test_launch_counts_exact_under_threads(self):
        """``_build.count_launch`` loses no count with 8 threads racing
        at a tiny switch interval (a bare ``+=`` on the attribute can)."""
        def wrapper():
            pass

        wrapper.launches = 0
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [
                _build.count_launch(wrapper) for _ in range(5000)])
                for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(old)
        assert wrapper.launches == 8 * 5000

    def test_segment_reduces_per_applied_sub_batch(self, tmp_path,
                                                   monkeypatch):
        """The accounting the chip smoke holds the card to, on the CPU:
        with the partitioned cascade, a pumped drain calls the segment
        reduce once per level for every sub-batch a range journal
        records as applied, counted across the pump threads, and not
        at all on a replay."""
        from heatmap_tpu_torch.ops import sparse_partitioned as sp

        calls = []
        real = sp._plain

        def counted(*a, **kw):
            calls.append(threading.get_ident())
            return real(*a, **kw)

        monkeypatch.setattr(sp, "_plain", counted)
        config = TConfig(**CONFIG, cascade_backend="partitioned")
        n_levels = config.cascade_config().n_levels + 1
        proot = str(tmp_path / "p")
        plane = _plane(TORCH, proot, config, n_writers=2)
        stats = twp.run_plane_ingest(plane, topen_source(BASE_SPEC),
                                     micro_batch=200)
        applied = sum(
            1 for name in plane.order
            for e in tdelta.DeltaJournal(os.path.join(
                twp.range_root(proot, name), "journal")).entries()
            if e["artifact"] != "-")
        assert applied == sum(p.applied for p in stats.pumps.values()) >= 4
        assert len(calls) == n_levels * applied
        assert len(set(calls)) == 2  # both pump threads launched
        calls.clear()
        replay = twp.run_plane_ingest(_plane(TORCH, proot, config,
                                             n_writers=2),
                                      topen_source(BASE_SPEC),
                                      micro_batch=200)
        assert replay.duplicates == replay.batches and not calls


class TestServeIntegration:
    def test_bare_path_sniffs_as_writeplane(self, scenario):
        proot = scenario["torch"]["proot"]
        assert TStore(proot).kind == JStore(proot).kind == "writeplane"
        assert TStore(f"writeplane:{proot}").kind == "writeplane"

    def test_delta_epoch_tracks_the_manifest(self, scenario):
        proot = scenario["torch"]["proot"]
        assert TStore(proot).delta_epoch == twp.read_pointer(proot) \
            == JStore(proot).delta_epoch

    def test_empty_plane_serves_empty(self, tmp_path):
        proot = str(tmp_path / "plane")
        _plane(TORCH, proot)
        assert _docs(TORCH, f"writeplane:{proot}") == {}
        assert _docs(JAX, f"writeplane:{proot}") == {}

    def test_roots_mount_across_packages(self, scenario):
        """A root written by either package answers every request the
        same in the other's ServeApp (status, bytes, ETag)."""
        for writer in BOTH:
            spec = f"writeplane:{scenario[writer.name]['proot']}"
            japp = JApp(JStore(spec), JCache())
            tapp = TApp(TStore(spec), TCache())
            assert (_collect_docs(TORCH, tapp.store)
                    == _collect_docs(JAX, japp.store)
                    == scenario["docs_ref"])
            keys = sorted(scenario["docs_ref"])[:: max(
                1, len(scenario["docs_ref"]) // 20)]
            paths = [f"/tiles/{name.replace('|', '%7C')}/{z}/{x}/{y}.{fmt}"
                     for name, z, x, y in keys for fmt in ("png", "json")]
            for path in paths + ["/tiles/default/0/0/0.png", "/healthz"]:
                want, got = japp.handle("GET", path), tapp.handle("GET", path)
                if path == "/healthz":
                    assert got[0] == want[0] == 200
                    continue
                assert (got[0], got[2], got[3]) == (want[0], want[2],
                                                    want[3]), path

    def test_key_set_union_is_the_set_union(self, scenario):
        """The plane's union of its ranges' ``TileKeySet``s (merged group
        by group) is the union of the Python sets the JAX plane builds."""
        results = list(scenario["torch"]["r1"].results.values())
        a, b = results[0].affected_keys, results[1].affected_keys
        union = a | b
        assert type(union) is type(a)
        assert set(union) == set(a) | set(b) and len(union) == len(
            set(a) | set(b))
        assert (a | set()) is a
        assert (a | {("x", 0, 0, 0, "png")}) == set(a) | {
            ("x", 0, 0, 0, "png")}

    def test_refresh_serving_after_publish_matches_jax(self, scenario,
                                                       tmp_path):
        """An append + publish, then ``refresh_serving`` on a mounted
        store with a warm cache: the same entries dropped as the JAX
        refresh, and the refreshed store serves a cold mount's docs."""
        dropped = {}
        for pkg, App, Cache in ((JAX, JApp, JCache), (TORCH, TApp, TCache)):
            s = scenario[pkg.name]
            proot = str(tmp_path / pkg.name)
            plane = _plane(pkg, proot, n_writers=2)
            plane.append_columns(s["b1"])
            plane.publish()
            app = App(pkg.Store(f"writeplane:{proot}"), Cache())
            for name, z, x, y in sorted(_collect_docs(pkg, app.store))[:40]:
                app.handle("GET", f"/tiles/{name.replace('|', '%7C')}/"
                           f"{z}/{x}/{y}.json")
            res = plane.append_columns(s["b2"])
            plane.publish()
            dropped[pkg.name] = pkg.wp.refresh_serving(res, app.store,
                                                       app.cache)
            assert (_collect_docs(pkg, app.store)
                    == _docs(pkg, f"writeplane:{proot}"))
        assert dropped["torch"] == dropped["jax"] > 0
