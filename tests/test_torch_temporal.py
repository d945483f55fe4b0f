"""The port's temporal plane (heatmap_tpu_torch.temporal, the bucketed
compaction, sweep and retraction of heatmap_tpu_torch.delta, the ingest
loop's window roll and the serve tier's temporal tiles and
``op=topk_growth``) on the CPU against the JAX package's.

Every case of tests/test_temporal.py runs here on both packages, with
its ``TCFG``, ``CONFIG`` and seeded batches: the port must pass the JAX
test's own assertion and give the JAX package's bytes (``TEMPORAL.json``
and bucket directories, folds, tile bodies and ETags, ``topk_growth``
answers with their ``max_err``, retraction summaries, quarantine
lists). Then stores written by one package are mounted, folded,
retracted and compacted by the other."""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import shutil
import types

import numpy as np
import pytest

from heatmap_tpu import delta as jdelta
from heatmap_tpu.delta import recover as jrecover
from heatmap_tpu.delta import retract as jretract
from heatmap_tpu.delta.compute import affected_tile_keys as jaffected
from heatmap_tpu.ingest import loop as jloop
from heatmap_tpu.io import merge as jmerge
from heatmap_tpu.io.sinks import LevelArraysSink as JLevelArraysSink
from heatmap_tpu.pipeline import BatchJobConfig as JBatchJobConfig
from heatmap_tpu.pipeline import run_job as jrun_job
from heatmap_tpu.serve import ServeApp as JServeApp
from heatmap_tpu.serve import TileCache as JTileCache
from heatmap_tpu.serve import TileStore as JTileStore
from heatmap_tpu.serve.render import tile_json_bytes as jtile_json_bytes
from heatmap_tpu.synopsis import transform as jtransform
from heatmap_tpu.temporal import buckets as jtb
from heatmap_tpu.temporal import fold as jfold
from heatmap_tpu.temporal import timequery as jtimequery
from heatmap_tpu_torch import delta as tdelta
from heatmap_tpu_torch.delta import recover as trecover
from heatmap_tpu_torch.delta import retract as tretract
from heatmap_tpu_torch.delta.compute import affected_tile_keys as taffected
from heatmap_tpu_torch.ingest import loop as tloop
from heatmap_tpu_torch.io import merge as tmerge
from heatmap_tpu_torch.io.sinks import LevelArraysSink as TLevelArraysSink
from heatmap_tpu_torch.pipeline.batch import BatchJobConfig as TBatchJobConfig
from heatmap_tpu_torch.pipeline.batch import run_job as trun_job
from heatmap_tpu_torch.serve import ServeApp as TServeApp
from heatmap_tpu_torch.serve import TileCache as TTileCache
from heatmap_tpu_torch.serve import TileStore as TTileStore
from heatmap_tpu_torch.serve.render import tile_json_bytes as ttile_json_bytes
from heatmap_tpu_torch.synopsis import transform as ttransform
from heatmap_tpu_torch.temporal import buckets as ttb
from heatmap_tpu_torch.temporal import fold as tfold
from heatmap_tpu_torch.temporal import timequery as ttimequery
from heatmap_tpu_torch.utils.checkpoint import load_checkpoint

#: The compaction modules (the delta packages export a ``compact``
#: function under the same name).
jcompact = importlib.import_module("heatmap_tpu.delta.compact")
tcompact = importlib.import_module("heatmap_tpu_torch.delta.compact")

TCFG = {"width": 100.0, "fanout": 2, "keep": 2, "tiers": 3}

#: One namespace per package, so every scenario runs the same code on
#: both (the port's cascade on the CPU).
JAX = types.SimpleNamespace(
    name="jax", delta=jdelta, compact=jcompact, recover=jrecover,
    retract=jretract, affected=jaffected, loop=jloop, merge=jmerge,
    Sink=JLevelArraysSink, config=JBatchJobConfig(detail_zoom=8,
                                                  min_detail_zoom=5),
    run_job=jrun_job, ServeApp=JServeApp, TileCache=JTileCache,
    TileStore=JTileStore, tile_json_bytes=jtile_json_bytes, tb=jtb,
    fold=jfold, timequery=jtimequery, kw={})
TORCH = types.SimpleNamespace(
    name="torch", delta=tdelta, compact=tcompact, recover=trecover,
    retract=tretract, affected=taffected, loop=tloop, merge=tmerge,
    Sink=TLevelArraysSink, config=TBatchJobConfig(detail_zoom=8,
                                                  min_detail_zoom=5),
    run_job=trun_job, ServeApp=TServeApp, TileCache=TTileCache,
    TileStore=TTileStore, tile_json_bytes=ttile_json_bytes, tb=ttb,
    fold=tfold, timequery=ttimequery, kw={"device": "cpu"})
PKGS = {"jax": JAX, "torch": TORCH}


@pytest.fixture(autouse=True)
def _clear_sweep_caches():
    yield
    trecover.clear_verified_cache()
    jrecover.clear_verified_cache()


def _batch(seed: int, t0: float | None, n: int = 40) -> dict:
    rng = np.random.default_rng(seed)
    cols = {
        "latitude": rng.uniform(30.0, 50.0, n),
        "longitude": rng.uniform(-120.0, -70.0, n),
        "user_id": ["alice" if i % 2 else "bob" for i in range(n)],
    }
    if t0 is not None:
        cols["timestamp"] = [str(float(t0 + i)) for i in range(n)]
    return cols


def _union(*batches: dict) -> dict:
    out = {}
    for k in batches[0]:
        vals = []
        for b in batches:
            v = b[k]
            vals.extend(list(v) if not isinstance(v, np.ndarray)
                        else list(np.asarray(v)))
        out[k] = vals
    return out


def _apply(p, root, cols, **kw):
    return p.delta.apply_batch(root, p.delta.ColumnsSource(cols), p.config,
                               **kw, **p.kw)


def _levelbytes(levels: list) -> list:
    """Canonical (dtype + raw bytes) form of finalized level dicts."""
    out = []
    for lvl in levels:
        rec = {}
        for k, v in sorted(lvl.items()):
            if hasattr(v, "__len__") and not isinstance(v, str):
                a = np.asarray(v)
                rec[k] = (str(a.dtype), a.tobytes())
            else:
                rec[k] = v
        out.append((int(lvl["zoom"]), rec))
    return out


def _oracle_levels(p, *dir_weight_pairs) -> list:
    """The JAX test's clean-recompute oracle through ``p``'s merge."""
    parts = []
    for d, w in dir_weight_pairs:
        loaded = p.Sink.load(d)
        part = []
        for z in sorted(loaded):
            cols = loaded[z]
            if w != 1.0:
                cols = dict(cols)
                cols["value"] = np.asarray(cols["value"], np.float64) * w
            part.append(p.merge._loaded_to_finalized(cols))
        parts.append(part)
    return p.compact.drop_zero_rows(p.merge.merge_level_parts(parts))


def _tree(root: str) -> dict:
    """{relative path: bytes} under ``root``; journal entries as their
    arrays and meta without the wall-clock ``ts``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if rel.startswith("journal" + os.sep):
                arrays, meta = load_checkpoint(full)
                meta.pop("ts", None)
                out[rel] = (json.dumps(meta, sort_keys=True),
                            {k: v.tolist() for k, v in arrays.items()})
            else:
                with open(full, "rb") as f:
                    out[rel] = f.read()
    return out


def _tree_digest(root: str) -> str:
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for fn in sorted(filenames):
            path = os.path.join(dirpath, fn)
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _base_file_hashes(root: str, *, skip=("TEMPORAL.json",)) -> dict:
    base = os.path.join(root, tcompact.read_current(root)["base"])
    out = {}
    for name in sorted(os.listdir(base)):
        path = os.path.join(base, name)
        if os.path.isfile(path) and name not in skip:
            with open(path, "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _temporal_tree(root: str) -> dict:
    """The base's ``TEMPORAL.json`` and bucket files."""
    base = os.path.join(root, tcompact.read_current(root)["base"])
    return {k: v for k, v in _tree(base).items()
            if k == "TEMPORAL.json" or k.startswith("buckets" + os.sep)}


def _build_scenario(p, tp):
    """tests/test_temporal.py's ``scenario`` fixture through ``p``."""
    root = str(tp / "store")
    rootu = str(tp / "store_unbucketed")
    batches = {k: _batch(i, t0) for i, (k, t0) in enumerate(
        [("b1", 1000), ("b2", 1120), ("b3", 1310), ("b4", 1440),
         ("b5", None)])}
    os.makedirs(root)
    p.fold.ensure_config(root, **TCFG)
    for key in ("b1", "b2", "b3", "b4", "b5"):
        _apply(p, root, batches[key])
        _apply(p, rootu, batches[key])
    comp = p.delta.compact(root, retention=10)
    compu = p.delta.compact(rootu, retention=10)
    groups = {
        "g12": _union(batches["b1"], batches["b2"]),
        "g3": batches["b3"], "g4": batches["b4"], "gnone": batches["b5"],
    }
    gdirs = {}
    for name, cols in groups.items():
        d = str(tp / f"oracle_{name}")
        p.run_job(p.delta.ColumnsSource(cols), p.Sink(d), p.config, **p.kw)
        gdirs[name] = d
    folds = {
        "all": p.fold.fold_levels(root, p.fold.select_fold(root)),
        "asof": p.fold.fold_levels(root, p.fold.select_fold(root,
                                                            as_of=1250)),
        "window": p.fold.fold_levels(root, p.fold.select_fold(
            root, window=150.0)),
        "decay": p.fold.fold_levels(root, p.fold.select_fold(
            root, decay=100.0), decay_half_life=100.0),
    }
    token_before_live = p.fold.select_fold(root, as_of=1250).token
    tree_compacted = _tree(root)
    res6 = _apply(p, root, _batch(6, 1520, n=20))
    return {"root": root, "rootu": rootu, "batches": batches,
            "gdirs": gdirs, "folds": folds, "comp": comp, "compu": compu,
            "token_before_live": token_before_live, "res6": res6,
            "tree_compacted": tree_compacted}


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    return {name: _build_scenario(
        p, tmp_path_factory.mktemp(f"temporal_{name}"))
        for name, p in PKGS.items()}


def _strip_seconds(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "seconds"}


class TestBucketedCompaction:
    def test_manifest_shape_and_coarsening(self, scenarios):
        s = scenarios["torch"]
        cur = tcompact.read_current(s["root"])
        man = ttb.read_manifest(os.path.join(s["root"], cur["base"]))
        assert man is not None and man["schema"] == ttb.TEMPORAL_SCHEMA
        names = {b["name"]: b for b in man["buckets"]}
        assert set(names) == {"bucket-1000-1200", "bucket-1300-1400",
                              "bucket-1400-1500"}
        assert names["bucket-1000-1200"]["tier"] == 1
        assert sorted(names["bucket-1000-1200"]["epochs"]) == [1, 2]
        assert man["none"] is not None
        assert s["comp"]["buckets"] == 4
        # TEMPORAL.json and every bucket file are the JAX package's, as
        # is the whole compacted store but for the journal's timestamps.
        j = scenarios["jax"]
        assert _temporal_tree(s["root"]) == _temporal_tree(j["root"])
        assert s["tree_compacted"] == j["tree_compacted"]
        assert (_strip_seconds(s["comp"]) == _strip_seconds(j["comp"]))

    def test_alltime_artifact_byte_identical_to_unbucketed(self, scenarios):
        s, j = scenarios["torch"], scenarios["jax"]
        assert (_base_file_hashes(s["root"])
                == _base_file_hashes(s["rootu"]))
        assert s["compu"].get("buckets") is None
        assert _base_file_hashes(s["root"]) == _base_file_hashes(j["root"])
        assert _tree(s["rootu"]) == _tree(j["rootu"])

    def test_fold_over_everything_equals_overlay(self, scenarios):
        s, j = scenarios["torch"], scenarios["jax"]
        got = tfold.fold_levels(s["root"], tfold.select_fold(s["root"]))
        assert _levelbytes(got) == _levelbytes(
            tcompact.load_overlay_levels(s["root"]))
        assert _levelbytes(got) == _levelbytes(
            jfold.fold_levels(j["root"], jfold.select_fold(j["root"])))

    def test_config_pinned_first_writer_wins(self, scenarios, tmp_path):
        s = scenarios["torch"]
        with pytest.raises(ValueError, match="pinned temporal config"):
            tfold.ensure_config(s["root"], width=999.0)
        assert tfold.ensure_config(str(tmp_path / "empty")) is None
        # One package pins, the other continues under the same pin.
        root = str(tmp_path / "pinned")
        os.makedirs(root)
        assert jfold.ensure_config(root, **TCFG) == tfold.ensure_config(
            root, **TCFG)
        with pytest.raises(ValueError, match="pinned temporal config"):
            tfold.ensure_config(root, keep=3)
        assert ttb.normalize_config(None, **TCFG) == jtb.normalize_config(
            None, **TCFG)


class TestCuts:
    def _same_as_jax(self, scenarios, name):
        assert (_levelbytes(scenarios["torch"]["folds"][name])
                == _levelbytes(scenarios["jax"]["folds"][name]))

    def test_as_of_equals_clean_recompute(self, scenarios):
        g = scenarios["torch"]["gdirs"]
        assert _levelbytes(scenarios["torch"]["folds"]["asof"]) == \
            _levelbytes(_oracle_levels(TORCH, (g["g12"], 1.0),
                                       (g["gnone"], 1.0)))
        self._same_as_jax(scenarios, "asof")

    def test_window_equals_clean_recompute(self, scenarios):
        g = scenarios["torch"]["gdirs"]
        assert _levelbytes(scenarios["torch"]["folds"]["window"]) == \
            _levelbytes(_oracle_levels(TORCH, (g["g3"], 1.0),
                                       (g["g4"], 1.0), (g["gnone"], 1.0)))
        self._same_as_jax(scenarios, "window")

    def test_decay_equals_weighted_recompute(self, scenarios):
        g = scenarios["torch"]["gdirs"]
        assert _levelbytes(scenarios["torch"]["folds"]["decay"]) == \
            _levelbytes(_oracle_levels(
                TORCH, (g["g12"], 0.125), (g["g3"], 0.5), (g["g4"], 1.0),
                (g["gnone"], 1.0)))
        self._same_as_jax(scenarios, "decay")
        self._same_as_jax(scenarios, "all")

    def test_as_of_before_all_timed_data(self, scenarios):
        s, j = scenarios["torch"], scenarios["jax"]
        sel = tfold.select_fold(s["root"], as_of=10.0)
        assert not sel.buckets and not sel.live
        assert sel.none is not None
        got = tfold.fold_levels(s["root"], sel)
        assert _levelbytes(got) == _levelbytes(
            _oracle_levels(TORCH, (s["gdirs"]["gnone"], 1.0)))
        jsel = jfold.select_fold(j["root"], as_of=10.0)
        assert sel.token == jsel.token
        assert _levelbytes(got) == _levelbytes(
            jfold.fold_levels(j["root"], jsel))

    def test_as_of_token_survives_unrelated_ingest(self, scenarios):
        s, j = scenarios["torch"], scenarios["jax"]
        assert not s["res6"].duplicate
        sel = tfold.select_fold(s["root"], as_of=1250)
        assert sel.token == s["token_before_live"]
        assert sel.token == jfold.select_fold(j["root"], as_of=1250).token
        assert s["token_before_live"] == j["token_before_live"]

    def test_live_delta_folds_into_window(self, scenarios):
        s, j = scenarios["torch"], scenarios["jax"]
        sel = tfold.select_fold(s["root"], window=150.0)
        assert sel.ref == 1600.0
        assert [u["epoch"] for u in sel.live] == [6]
        jsel = jfold.select_fold(j["root"], window=150.0)
        assert (sel.ref, sel.lo, sel.hi, sel.token) == (
            jsel.ref, jsel.lo, jsel.hi, jsel.token)
        assert _levelbytes(tfold.fold_levels(s["root"], sel)) == \
            _levelbytes(jfold.fold_levels(j["root"], jsel))
        assert tfold.newest_edge(s["root"]) == jfold.newest_edge(j["root"])


def _app(p, root):
    return p.ServeApp(p.TileStore(f"delta:{root}"), p.TileCache())


def _same_response(a, b):
    assert (a[0], a[1], a[2], a[3], a[5]) == (b[0], b[1], b[2], b[3], b[5])
    assert getattr(a, "headers", None) == getattr(b, "headers", None)


class TestServing:
    @pytest.fixture()
    def apps(self, scenarios):
        return (_app(TORCH, scenarios["torch"]["root"]),
                _app(JAX, scenarios["jax"]["root"]))

    def test_as_of_tile_bytes_match_oracle_store(self, scenarios, apps,
                                                 tmp_path):
        app, japp = apps
        g = scenarios["torch"]["gdirs"]
        d = str(tmp_path / "asof_oracle")
        TLevelArraysSink(d).write_levels(
            _oracle_levels(TORCH, (g["g12"], 1.0), (g["gnone"], 1.0)))
        oracle = TTileStore(f"arrays:{d}")
        layer = oracle.layer("default")
        z = sorted(z for z in layer.levels if z <= 6)[-1]
        compared = 0
        for x in range(1 << z):
            for y in range(1 << z):
                want = ttile_json_bytes(layer, z, x, y)
                url = f"/tiles/default/{z}/{x}/{y}.json?as_of=1250"
                r = app.handle("GET", url)
                if want is None:
                    assert r[0] == 404
                else:
                    assert r[0] == 200 and r[2] == want
                    compared += 1
                _same_response(r, japp.handle("GET", url))
        assert compared > 0
        for url in ("/tiles/default/3/2/3.png?as_of=1250",
                    "/tiles/default/3/2/3.png?decay=100",
                    "/tiles/default/4/4/6.json?window=1d&decay=1h"):
            _same_response(app.handle("GET", url), japp.handle("GET", url))

    def test_temporal_etag_namespace_and_304(self, scenarios, apps):
        app, japp = apps
        r = app.handle("GET", "/tiles/default/2/0/1.json?window=150")
        assert r[0] == 200 and r[3].startswith('"t-')
        assert r.headers == {"X-Heatmap-Temporal": "window"}
        _same_response(r, japp.handle(
            "GET", "/tiles/default/2/0/1.json?window=150"))
        r304 = app.handle("GET", "/tiles/default/2/0/1.json?window=150",
                          if_none_match=r[3])
        assert r304[0] == 304 and r304[2] == b""
        r_all = app.handle("GET", "/tiles/default/2/0/1.json",
                           if_none_match=r[3])
        assert r_all[0] == 200 and not r_all[3].startswith('"t-')
        _same_response(r_all, japp.handle(
            "GET", "/tiles/default/2/0/1.json", if_none_match=r[3]))

    def test_window_param_registered_for_invalidation(self, scenarios,
                                                      apps):
        app, japp = apps
        for a in apps:
            a.handle("GET", "/tiles/default/2/0/1.json?window=150")
        assert app.cache.window_params() == ("150",)
        assert app.cache.window_params() == japp.cache.window_params()

    def test_bad_temporal_params_are_typed_400s(self, scenarios, apps):
        app, japp = apps
        for q in ("window=bogus", "as_of=nope", "decay=-3"):
            url = f"/tiles/default/2/0/1.json?{q}"
            r = app.handle("GET", url)
            assert r[0] == 400
            assert json.loads(r[2])["error"] == "bad temporal query"
            _same_response(r, japp.handle("GET", url))

    def test_store_without_temporal_config_400s(self, scenarios):
        app = _app(TORCH, scenarios["torch"]["rootu"])
        japp = _app(JAX, scenarios["jax"]["rootu"])
        for url in ("/tiles/default/2/0/1.json?as_of=1250",
                    "/query?op=topk_growth&z=8&window=300"):
            r = app.handle("GET", url)
            assert r[0] == 400
            assert "no temporal config" in json.loads(r[2])["detail"]
            _same_response(r, japp.handle("GET", url))

    def test_torn_bucket_serves_last_good_stale(self, scenarios, tmp_path):
        """The JAX test's scenario on a copy of each package's store:
        the same last-good bytes, the same stale answer and the same
        degraded causes."""
        out = {}
        for name, p in PKGS.items():
            root = str(tmp_path / name)
            shutil.copytree(scenarios[name]["root"], root)
            app = _app(p, root)
            url = None
            for z in (3, 2, 1):
                for x in range(1 << z):
                    for y in range(1 << z):
                        r = app.handle(
                            "GET",
                            f"/tiles/default/{z}/{x}/{y}.json?as_of=1250")
                        if r[0] == 200:
                            url = (f"/tiles/default/{z}/{x}/{y}.json"
                                   "?as_of=1250")
                            good = r[2]
                            break
                    if url:
                        break
                if url:
                    break
            assert url is not None
            all_before = app.handle("GET", "/tiles/default/2/0/1.json")
            bdir = os.path.join(root, tcompact.read_current(root)["base"],
                                ttb.BUCKETS_DIRNAME, "bucket-1000-1200")
            levels = sorted(f for f in os.listdir(bdir)
                            if f.endswith(".npz"))
            with open(os.path.join(bdir, levels[0]), "wb") as f:
                f.write(b"torn")
            app.store.reload()
            r = app.handle("GET", url)
            assert r[0] == 200 and r[2] == good and r[5] == "stale"
            assert "render" in app.degraded_causes()
            r_all = app.handle("GET", "/tiles/default/2/0/1.json")
            assert r_all[0] == all_before[0] and r_all[2] == all_before[2]
            r_cold = app.handle("GET",
                                "/tiles/default/1/1/1.json?as_of=1250")
            assert r_cold[0] in (404, 503)
            out[name] = (url, good, r[:4], r_all[:4], r_cold[0],
                         sorted(app.degraded_causes()))
        assert out["torch"] == out["jax"]

    def test_torn_bucket_quarantined_by_sweep(self, scenarios, tmp_path):
        out = {}
        for name, p in PKGS.items():
            root = str(tmp_path / name)
            shutil.copytree(scenarios[name]["root"], root)
            bdir = os.path.join(root, tcompact.read_current(root)["base"],
                                ttb.BUCKETS_DIRNAME, "bucket-1300-1400")
            levels = sorted(f for f in os.listdir(bdir)
                            if f.endswith(".npz"))
            with open(os.path.join(bdir, levels[0]), "wb") as f:
                f.write(b"torn")
            items = p.recover.sweep(root)["quarantined"]
            torn = [i for i in items if i["reason"] == "torn_bucket"]
            assert len(torn) == 1
            assert not os.path.isdir(bdir)
            with pytest.raises(p.fold.TornBucketError):
                p.fold.fold_levels(root, p.fold.select_fold(root,
                                                            window=300.0))
            assert p.compact.load_overlay_levels(root)
            out[name] = [{k: v for k, v in i.items()
                          if k not in ("dest", "detail")} for i in items]
            out[name + "_files"] = sorted(
                os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(os.path.join(root, "quarantine"))
                for f in fs)
        assert out["torch"] == out["jax"]
        assert len(out["torch_files"]) == len(out["jax_files"])


class TestBucketRoll:
    def test_roll_invalidates_exactly_the_retiring_keys(self, scenarios,
                                                        tmp_path):
        out = {}
        for name, p in PKGS.items():
            root = str(tmp_path / name)
            shutil.copytree(scenarios[name]["root"], root)
            cache = p.TileCache()
            holder: list = []
            assert p.loop._roll_windows(root, cache, holder) == 0
            assert holder == [1600.0]
            cache.note_window_param("150")
            cur = tcompact.read_current(root)
            bdir = os.path.join(root, cur["base"], ttb.BUCKETS_DIRNAME,
                                "bucket-1400-1500")
            retiring = sorted(p.affected(p.Sink.load(bdir)))
            doomed = tuple(retiring[0]) + ("w", "150")
            survivor_window = ("not-a-real-tile", 9, 9, 9, "json", "w",
                               "150")
            survivor_token = tuple(retiring[0]) + ("t", "sometoken")
            alltime = tuple(retiring[-1])
            others = [tuple(k) + ("w", "150") for k in retiring[1:40]]
            for key in (doomed, survivor_window, survivor_token, alltime,
                        *others):
                cache.get_or_render(key, 0, lambda: b"x")
            _apply(p, root, _batch(7, 1610, n=10))
            n = p.loop._roll_windows(root, cache, holder)
            assert holder == [1700.0]
            assert n >= 1
            assert cache.get_or_render(doomed, 0, lambda: b"re")[1] is False
            for key in (survivor_window, survivor_token, alltime):
                assert cache.get_or_render(key, 0,
                                           lambda: b"re")[1] is True
            out[name] = (n, retiring)
        assert out["torch"] == out["jax"]


class TestTimeQuery:
    def _brute_growth(self, root: str, *, zoom: int, window: float):
        """The JAX test's oracle: per-cell exact growth from the raw
        bucket/live level rows, no wavelets anywhere."""
        sel = tfold.select_fold(root, window=window)
        base = tcompact.read_current(root).get("base")
        units = [(os.path.join(root, base, ttb.BUCKETS_DIRNAME, b["name"]),
                  float(b["t1"])) for b in sel.buckets]
        units += [(os.path.join(root, u["artifact"]), u["t1"])
                  for u in sel.live]
        mid = sel.ref - window / 2.0
        acc: dict = {}
        for d, t1 in units:
            lvl = TLevelArraysSink.load(d).get(zoom)
            if lvl is None:
                continue
            keep = ((np.asarray(lvl["user"], str) == "all")
                    & (np.asarray(lvl["timespan"], str) == "alltime"))
            sign = 1.0 if t1 > mid else -1.0
            for r, c, v in zip(np.asarray(lvl["row"])[keep],
                               np.asarray(lvl["col"])[keep],
                               np.asarray(lvl["value"])[keep]):
                acc[(int(r), int(c))] = acc.get((int(r), int(c)), 0.0) \
                    + sign * float(v)
        return acc

    def test_bound_is_sound_and_full_budget_exact(self, scenarios):
        s, j = scenarios["torch"], scenarios["jax"]
        kw = dict(user="all", timespan="alltime", zoom=8, window=300.0,
                  k=10)
        doc = ttimequery.topk_growth(s["root"], coeffs=2, **kw)
        oracle = self._brute_growth(s["root"], zoom=8, window=300.0)
        assert doc["cells"]
        for cell in doc["cells"]:
            exact = oracle.get((cell["row"], cell["col"]), 0.0)
            assert abs(cell["growth"] - exact) <= cell["bound"] + 1e-12
        full = ttimequery.topk_growth(s["root"], coeffs=64, **kw)
        assert full["max_err"] == 0.0
        for cell in full["cells"]:
            assert cell["growth"] == oracle[(cell["row"], cell["col"])]
        for coeffs in (1, 2, 3, 64):
            assert json.dumps(ttimequery.topk_growth(
                s["root"], coeffs=coeffs, **kw)) == json.dumps(
                jtimequery.topk_growth(j["root"], coeffs=coeffs, **kw))

    def test_query_endpoint(self, scenarios):
        app = _app(TORCH, scenarios["torch"]["root"])
        japp = _app(JAX, scenarios["jax"]["root"])
        url = "/query?op=topk_growth&layer=default&z=8&window=300&k=5"
        r = app.handle("GET", url)
        assert r[0] == 200
        doc = json.loads(r[2])
        assert doc["op"] == "topk_growth" and len(doc["cells"]) == 5
        assert r[3].startswith('"q-')
        assert "X-Heatmap-Query-Error" in (r.headers or {})
        _same_response(r, japp.handle("GET", url))
        r2 = app.handle("GET", url)
        assert r2[5] == "hit"
        _same_response(r2, japp.handle("GET", url))
        for bad in ("/query?op=topk_growth&layer=default&z=8",
                    "/query?op=topk_growth&z=8&window=300&k=0",
                    "/query?op=topk_growth&z=8&window=300&m=x",
                    "/query?op=topk_growth&layer=nope&z=8&window=1h"):
            r400 = app.handle("GET", bad)
            assert r400[0] in (400, 404)
            _same_response(r400, japp.handle("GET", bad))
        assert "window" in json.loads(app.handle(
            "GET", "/query?op=topk_growth&layer=default&z=8")[2])["detail"]

    def test_haar_roundtrip_exact_on_integers(self):
        rng = np.random.default_rng(3)
        x = rng.integers(0, 1000, size=(5, 16)).astype(np.float64)
        c = ttransform.haar1d_np(x)
        assert (ttransform.inv_haar1d_np(c) == x).all()
        assert c.tobytes() == jtransform.haar1d_np(x).tobytes()
        with pytest.raises(ValueError, match="power-of-two"):
            ttransform.haar1d_np(np.zeros(6))


def _retract_scenario(p, tp):
    roots = {"A": str(tp / "A"), "B": str(tp / "B")}
    for r in roots.values():
        os.makedirs(r)
        p.fold.ensure_config(r, **TCFG)
    for i, t0 in enumerate([1000, 1150]):
        b = _batch(i, t0)
        _apply(p, roots["A"], b)
        keep = [k for k, u in enumerate(b["user_id"]) if u != "alice"]
        bb = {k: ([v[m] for m in keep] if isinstance(v, list)
                  else np.asarray(v)[keep]) for k, v in b.items()}
        _apply(p, roots["B"], bb)
    summary = p.retract.retract_predicate(
        roots["A"], p.retract.parse_where(["user=alice"]), **p.kw)
    return {"roots": roots, "summary": summary}


@pytest.fixture(scope="module")
def retract_scenarios(tmp_path_factory):
    return {name: _retract_scenario(
        p, tmp_path_factory.mktemp(f"retract_{name}"))
        for name, p in PKGS.items()}


def _summary_core(s: dict) -> dict:
    return {k: v for k, v in s.items() if k not in ("seconds", "results")}


class TestRetraction:
    def test_counter_batches_land_per_bucket(self, retract_scenarios):
        s = retract_scenarios["torch"]["summary"]
        assert s["rows"] == 40
        assert s["batches"] == 2
        assert s["scanned"] == 80
        assert _summary_core(s) == _summary_core(
            retract_scenarios["jax"]["summary"])

    def test_byte_identical_to_survivor_recompute(self, retract_scenarios):
        roots = retract_scenarios["torch"]["roots"]
        assert _levelbytes(tcompact.load_overlay_levels(roots["A"])) == \
            _levelbytes(tcompact.load_overlay_levels(roots["B"]))
        assert _tree(roots["A"]) == _tree(
            retract_scenarios["jax"]["roots"]["A"])

    def test_idempotent_rerun_applies_nothing(self, retract_scenarios):
        out = {}
        for name, p in PKGS.items():
            root = retract_scenarios[name]["roots"]["A"]
            digest = _tree_digest(root)
            again = p.retract.retract_predicate(
                root, p.retract.parse_where(["user=alice"]), **p.kw)
            assert again["rows"] == 0 and again["batches"] == 0
            assert _tree_digest(root) == digest
            out[name] = _summary_core(again)
        assert out["torch"] == out["jax"]

    def test_identity_holds_after_compaction(self, retract_scenarios):
        out = {}
        for name, p in PKGS.items():
            roots = retract_scenarios[name]["roots"]
            p.delta.compact(roots["A"], retention=10)
            p.delta.compact(roots["B"], retention=10)
            assert _base_file_hashes(roots["A"]) == _base_file_hashes(
                roots["B"])
            folds = []
            for kw in ({"as_of": 1100}, {"window": 150.0}):
                fa = p.fold.fold_levels(roots["A"], p.fold.select_fold(
                    roots["A"], **kw))
                fb = p.fold.fold_levels(roots["B"], p.fold.select_fold(
                    roots["B"], **kw))
                assert _levelbytes(fa) == _levelbytes(fb)
                folds.append(_levelbytes(fa))
            out[name] = (folds, _tree(roots["A"]))
        assert out["torch"] == out["jax"]

    def test_where_parsing(self):
        for mod in (tretract, jretract):
            assert mod.parse_where(["user=alice"]) == {"user_id": "alice"}
            assert mod.parse_where(["layer=x", "source=gps"]) == {
                "user_id": "x", "source": "gps"}
            with pytest.raises(ValueError, match="column=value"):
                mod.parse_where(["nonsense"])
            with pytest.raises(ValueError, match="not a point column"):
                mod.parse_where(["zoom=3"])
            with pytest.raises(ValueError, match="at least one"):
                mod.parse_where([])

    def test_unpinned_store_refuses(self, tmp_path):
        msgs = []
        for name, p in PKGS.items():
            root = str(tmp_path / name / "empty")
            with pytest.raises(ValueError, match="no pinned config") as e:
                p.retract.retract_predicate(
                    root, p.retract.parse_where(["user=alice"]), **p.kw)
            msgs.append(str(e.value).replace(root, "R"))
        assert msgs[0] == msgs[1]


def _lifecycle(first, second, tp):
    """A pinned store written and compacted by ``first``, then mounted,
    folded, appended to, retracted and compacted again by ``second``.
    Returns (root, what ``second`` read and answered)."""
    root = str(tp / f"{first.name}_{second.name}")
    os.makedirs(root)
    first.fold.ensure_config(root, **TCFG)
    for i, t0 in enumerate([1000, 1120, 1310, 1440, None]):
        _apply(first, root, _batch(i, t0))
    first.delta.compact(root, retention=10)
    assert second.fold.ensure_config(root, **TCFG) is not None
    app = _app(second, root)
    answers = [app.handle("GET", url)[:4] for url in (
        "/tiles/default/3/2/3.json?as_of=1250",
        "/tiles/default/3/2/3.json?window=150",
        "/tiles/default/3/2/3.png?decay=100",
        "/query?op=topk_growth&z=8&window=300&k=5")]
    folds = [_levelbytes(second.fold.fold_levels(
        root, second.fold.select_fold(root, **kw),
        decay_half_life=kw.get("decay"))) for kw in (
        {}, {"as_of": 1250}, {"window": 150.0}, {"decay": 100.0})]
    _apply(second, root, _batch(6, 1520, n=20))
    summary = second.retract.retract_predicate(
        root, second.retract.parse_where(["user=alice"]), **second.kw)
    comp = second.delta.compact(root, retention=10)
    folds.append(_levelbytes(second.fold.fold_levels(
        root, second.fold.select_fold(root, window=300.0))))
    return root, (answers, folds, _summary_core(summary),
                  _strip_seconds(comp))


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_temporal_store_continues_across_packages(tmp_path, first, second):
    """The north star the temporal refusals broke: a store pinned and
    compacted by one package is mounted, folded, retracted and compacted
    again by the other, with the bytes of the same sequence run by one
    package alone."""
    mixed, got = _lifecycle(PKGS[first], PKGS[second], tmp_path)
    alone, want = _lifecycle(PKGS[second], PKGS[second], tmp_path)
    assert got == want
    assert _tree(mixed) == _tree(alone)
    assert trecover.sweep(mixed)["quarantined"] == []


TCLI_ZOOM = ["--detail-zoom", "10"]


def _cli_steps(root):
    return [
        ["update", "--journal", root, "--input", "synthetic:1500:0",
         "--bucket-width", "3600", "--bucket-keep", "2", *TCLI_ZOOM],
        ["update", "--journal", root, "--input", "synthetic:400:1",
         *TCLI_ZOOM],
        ["update", "--journal", root, "--input", "synthetic:400:2",
         "--bucket-width", "3600", "--bucket-keep", "2",
         "--compact-after", "0", *TCLI_ZOOM],
        ["update", "--journal", root, "--input", "synthetic:300:3",
         *TCLI_ZOOM],
        ["retract", "--journal", root, "--where", "user=user-3"],
        ["update", "--journal", root, "--compact-after", "0",
         "--retention", "1"],
    ]


def _cli(cli, argv, capsys):
    argv = [*argv, *(["--device", "cpu"] if cli.__name__.startswith(
        "heatmap_tpu_torch") else ["--backend", "cpu"])]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out.pop("seconds", None)
    out.pop("device", None)
    return out


def test_update_and_retract_commands_on_a_pinned_store(tmp_path, capsys):
    """``update --bucket-*`` pins the config and prints it under
    ``temporal``; a repeat with the same flags passes, ``retract
    --where`` lands its counter-batches per bucket, and compaction
    writes the buckets: the JAX CLI's summaries and store."""
    from heatmap_tpu import cli as jcli
    from heatmap_tpu_torch import cli as tcli

    got = [_cli(tcli, a, capsys) for a in _cli_steps(str(tmp_path / "t"))]
    want = [_cli(jcli, a, capsys) for a in _cli_steps(str(tmp_path / "j"))]
    for a in (got, want):
        for s in a:
            s.pop("journal", None)
    assert got == want
    assert got[0]["temporal"] == {"width": 3600.0, "fanout": 4, "keep": 2,
                                  "tiers": 4, "unit_s": 1.0}
    assert got[4]["rows"] > 0 and got[4]["batches"] >= 1
    assert _tree(str(tmp_path / "t")) == _tree(str(tmp_path / "j"))
    assert ttb.read_manifest(os.path.join(
        str(tmp_path / "t"),
        tcompact.read_current(str(tmp_path / "t"))["base"]))["buckets"]
    # A mismatched pin is the JAX one-line operator error.
    bad = ["update", "--journal", str(tmp_path / "t"), "--input",
           "synthetic:10:9", "--bucket-width", "60", *TCLI_ZOOM]
    for cli, dev in ((tcli, ["--device", "cpu"]), (jcli, ["--backend",
                                                          "cpu"])):
        with pytest.raises(SystemExit, match="pinned temporal config"):
            cli.main([*bad, *dev])


def test_ingest_command_with_buckets_equal_jax(tmp_path, capsys):
    """``ingest --bucket-*`` pins the config (summary ``temporal``) and
    its compactions write buckets: the JAX ``ingest``'s summary and
    store."""
    from heatmap_tpu import cli as jcli
    from heatmap_tpu_torch import cli as tcli

    def argv(root):
        return ["ingest", "--journal", root, "--input", "synthetic:3000:3",
                "--micro-batch", "1000", "--compact-every", "2",
                "--queue-depth", "0", "--bucket-width", "3600",
                "--bucket-fanout", "2", *TCLI_ZOOM]

    from heatmap_tpu.pipeline import bucketing as jbucketing
    from heatmap_tpu_torch.pipeline import bucketing as tbucketing

    # compile_cache counts the process's dispatch signatures: start both
    # packages' mirrors empty.
    tbucketing.reset_cache_stats()
    got = _cli(tcli, argv(str(tmp_path / "t")), capsys)
    jbucketing.reset_cache_stats()
    want = _cli(jcli, argv(str(tmp_path / "j")), capsys)
    for s in (got, want):
        for k in ("journal", "ticks_per_s", "points_per_s", "lag_p50_s",
                  "lag_max_s", "tick_p50_s", "tick_max_s"):
            s.pop(k, None)
    assert got["temporal"] == want["temporal"]
    assert got == want
    assert _tree(str(tmp_path / "t")) == _tree(str(tmp_path / "j"))
