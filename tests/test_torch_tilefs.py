"""The port's tilefs (heatmap_tpu_torch.tilefs) against the JAX
package's: mirror files byte for byte from either writer, the mmap'd
reader and the deep verifier, the ``arrays-tilefs:`` sink, compaction of
a base that carries mirrors, the recovery sweep's ``torn_tilefs``, the
disk cache tier and the pre-warm plan."""

import json
import os

import numpy as np
import pytest

from heatmap_tpu import delta as jdelta
from heatmap_tpu.delta import recover as jrecover
from heatmap_tpu.io import open_sink as jopen_sink
from heatmap_tpu.io import open_source as jopen_source
from heatmap_tpu.pipeline import batch as jbatch
from heatmap_tpu.serve import ServeApp as JApp
from heatmap_tpu.serve import TileCache as JCache
from heatmap_tpu.serve import TileStore as JStore
from heatmap_tpu.tilefs import diskcache as jdiskcache
from heatmap_tpu.tilefs import format as jformat
from heatmap_tpu.tilefs import prewarm as jprewarm
from heatmap_tpu_torch import delta as tdelta
from heatmap_tpu_torch.delta import recover as trecover
from heatmap_tpu_torch.io import open_sink as topen_sink
from heatmap_tpu_torch.io import open_source as topen_source
from heatmap_tpu_torch.pipeline import batch as tbatch
from heatmap_tpu_torch.serve import ServeApp as TApp
from heatmap_tpu_torch.serve import TileCache as TCache
from heatmap_tpu_torch.serve import TileStore as TStore
from heatmap_tpu_torch.tilefs import diskcache, prewarm
from heatmap_tpu_torch.tilefs import format as tformat

CFG = dict(detail_zoom=10, min_detail_zoom=5)


@pytest.fixture(autouse=True)
def _clear_sweep_cache():
    yield
    trecover.clear_verified_cache()
    jrecover.clear_verified_cache()


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if rel.startswith("journal" + os.sep):
                continue  # wall-clock ts in the entry meta
            with open(full, "rb") as f:
                out[rel] = f.read()
    return out


def _pairs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for user, ts in (("all", "alltime"), ("user-1", "alltime"),
                     ("all", "2024-05")):
        n = int(rng.integers(0, 300))
        out.append((user, ts, rng.integers(0, 1 << 20, n),
                    rng.integers(1, 9, n).astype(np.float64)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_tilefs_bytes_match_jax(tmp_path, seed):
    pairs = _pairs(seed)
    a = tformat.write_tilefs(str(tmp_path / "t"), 10, 5, pairs)
    b = jformat.write_tilefs(str(tmp_path / "j"), 10, 5, pairs)
    assert os.path.basename(a) == os.path.basename(b) == "tilefs-z10.bin"
    assert open(a, "rb").read() == open(b, "rb").read()
    # Each package reads the other's file to the same views.
    tr, jr = tformat.open_tilefs(b), jformat.open_tilefs(a)
    assert tr.pairs == jr.pairs and (tr.zoom, tr.coarse_zoom) == (10, 5)
    for seg in tr.pairs:
        for x, y in zip(tr.arrays(seg), jr.arrays(seg)):
            np.testing.assert_array_equal(x, y)
    assert tformat.verify_tilefs(b) is None
    assert tformat.sniff_tilefs(str(tmp_path / "j"))
    assert tformat.list_tilefs(str(tmp_path / "t")) == {10: a}


@pytest.mark.parametrize("damage", ["truncate", "flip_payload",
                                    "flip_footer", "magic"])
def test_torn_files_fail_as_in_jax(tmp_path, damage):
    path = tformat.write_tilefs(str(tmp_path), 8, 3, _pairs(4))
    data = bytearray(open(path, "rb").read())
    if damage == "truncate":
        data = data[:len(data) // 2]
    elif damage == "flip_payload":
        data[tformat.HEADER_SIZE + 3] ^= 0xFF
    elif damage == "flip_footer":
        data[-tformat.TRAILER_SIZE - 5] ^= 0xFF
    else:
        data[:8] = b"NOTTILEF"
    with open(path, "wb") as f:
        f.write(bytes(data))
    got, want = tformat.verify_tilefs(path), jformat.verify_tilefs(path)
    assert got is not None and got == want
    for fmt in (tformat, jformat):
        if damage != "flip_payload":
            with pytest.raises(fmt.TilefsError):
                fmt.open_tilefs(path)
    assert (tformat.sniff_tilefs(str(tmp_path))
            == jformat.sniff_tilefs(str(tmp_path)))


def test_write_from_loaded_matches_jax(tmp_path):
    with topen_sink(f"arrays:{tmp_path / 'lv'}") as sink:
        tbatch.run_job(topen_source("synthetic:2000:9"), sink,
                       tbatch.BatchJobConfig(**CFG), device="cpu")
    from heatmap_tpu_torch.io.sinks import LevelArraysSink

    levels = LevelArraysSink.load(str(tmp_path / "lv"))
    a = tformat.write_tilefs_from_loaded(str(tmp_path / "t"), levels)
    b = jformat.write_tilefs_from_loaded(str(tmp_path / "j"), levels)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p)
                                                for p in b]
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def _mirrored_store(tmp_path, pkg):
    """A delta store whose base carries tilefs mirrors, plus one live
    delta, written by ``pkg``."""
    root = str(tmp_path / pkg / "store")
    base = str(tmp_path / pkg / "base")
    if pkg == "torch":
        mod, cfg, src, sink, kw = (tdelta, tbatch.BatchJobConfig(**CFG),
                                   topen_source, topen_sink,
                                   {"device": "cpu"})
    else:
        mod, cfg, src, sink, kw = (jdelta, jbatch.BatchJobConfig(**CFG),
                                   jopen_source, jopen_sink, {})
    with sink(f"arrays-tilefs:{base}") as s:
        (tbatch if pkg == "torch" else jbatch).run_job(
            src("synthetic:1500:2"), s, cfg, **kw)
    mod.init_store(root, base_dir=base)
    mod.apply_batch(root, src("synthetic:300:3"), cfg, **kw)
    return root, mod


def test_run_arrays_tilefs_output_matches_jax(tmp_path):
    """``run --output arrays-tilefs:DIR`` writes the JAX run's levels
    and tilefs mirrors, byte for byte."""
    from heatmap_tpu import cli as jcli
    from heatmap_tpu_torch import cli as tcli

    argv = ["run", "--input", "synthetic:300:2", "--backend", "cpu",
            "--detail-zoom", "10"]
    assert tcli.main([*argv, "--output",
                      f"arrays-tilefs:{tmp_path / 't'}"]) == 0
    assert jcli.main([*argv, "--output",
                      f"arrays-tilefs:{tmp_path / 'j'}"]) == 0

    def tree(root):
        return {str(p.relative_to(root)): p.read_bytes()
                for p in sorted(root.rglob("*")) if p.is_file()}

    got = tree(tmp_path / "t")
    assert any(n.startswith("tilefs-z") for n in got)
    assert got == tree(tmp_path / "j")


def test_compaction_keeps_mirrors_as_jax(tmp_path):
    """Compaction of a base with mirrors writes a new base with fresh
    mirrors, byte for byte the JAX package's, and a tilefs: mount over
    the store serves the same bytes before and after."""
    roots = {}
    for pkg in ("jax", "torch"):
        root, mod = _mirrored_store(tmp_path, pkg)
        roots[pkg] = (root, mod)
    japp = JApp(JStore(roots["jax"][0]), JCache())
    tapp = TApp(TStore(roots["torch"][0]), TCache())
    assert japp.store.kind == tapp.store.kind == "tilefs"
    paths = _tile_paths(japp)
    for path in paths:
        _same(japp, tapp, path)
    for pkg, (root, mod) in roots.items():
        assert mod.compact(root)["status"] == "ok"
    jt, tt = _tree(roots["jax"][0]), _tree(roots["torch"][0])
    assert any("tilefs-z" in n for n in tt)
    assert jt == tt
    for app in (japp, tapp):
        app.store.reload()
    for path in paths:
        _same(japp, tapp, path)


def test_sweep_quarantines_torn_mirror_as_jax(tmp_path):
    """A torn mirror in CURRENT's base: both sweeps quarantine it with
    reason torn_tilefs, and serving falls back to the npz level with the
    same bytes."""
    events = {}
    for pkg in ("jax", "torch"):
        root, mod = _mirrored_store(tmp_path, pkg)
        mod.compact(root)
        cur = json.load(open(os.path.join(root, "CURRENT")))
        mirror = os.path.join(root, cur["base"], "tilefs-z08.bin")
        with open(mirror, "r+b") as f:
            f.truncate(os.path.getsize(mirror) // 2)
        rec = (trecover if pkg == "torch" else jrecover)
        events[pkg] = rec.sweep(root)
        assert not os.path.exists(mirror)
    want = [(i["reason"], i["kind"], i["path"])
            for i in _items(events["jax"])]
    got = [(i["reason"], i["kind"], i["path"])
           for i in _items(events["torch"])]
    assert got == want
    assert [g[:2] for g in got] == [("torn_tilefs", "tilefs")]
    japp = JApp(JStore(str(tmp_path / "jax" / "store")), JCache())
    tapp = TApp(TStore(str(tmp_path / "torch" / "store")), TCache())
    for path in _tile_paths(japp):
        _same(japp, tapp, path)


def _items(result):
    return result["quarantined"]


def _tile_paths(app):
    from heatmap_tpu.tilemath.morton import morton_decode_np

    layer = app.store.layer("default")
    out = []
    for d in layer.detail_zooms:
        z = d - layer.result_delta
        codes = np.unique(np.asarray(layer.levels[d].codes)
                          >> (2 * layer.result_delta))[:4]
        r, c = morton_decode_np(np.asarray(codes, np.int64))
        out += [f"/tiles/default/{z}/{x}/{y}.{fmt}"
                for x, y in zip(c.tolist(), r.tolist())
                for fmt in ("png", "json")]
    return out + ["/healthz"]


def _same(japp, tapp, path):
    a, b = japp.handle("GET", path), tapp.handle("GET", path)
    jroot = japp.store.spec.partition(":")[2] or japp.store.spec
    troot = tapp.store.spec.partition(":")[2] or tapp.store.spec
    body = a[2].replace(jroot.encode(), troot.encode())
    assert (a[0], body, a[4], a[5]) == (b[0], b[2], b[4], b[5]), path
    if body == a[2]:
        assert a[3] == b[3], path


def test_disk_cache_entries_match_jax(tmp_path):
    keys = [(("default", 3, 1, 2, "png"), 0, 2), (("x", 0, 0, 0, "json"),
                                                  1, 0)]
    tc = diskcache.DiskTileCache(str(tmp_path / "t"), max_bytes=1 << 20)
    jc = jdiskcache.DiskTileCache(str(tmp_path / "j"), max_bytes=1 << 20)
    for i, key in enumerate(keys):
        value = b"tile-bytes" * (i + 1) if i == 0 else "a str payload"
        assert tc.put(key, value) == jc.put(key, value)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    # Each package reads the other's entries.
    other = diskcache.DiskTileCache(str(tmp_path / "j"))
    for key in keys:
        assert other.get(key) == jc.get(key) is not None
    # A torn entry reads as a miss in both.
    for root in ("t", "j"):
        for dirpath, _d, files in os.walk(tmp_path / root):
            for name in files:
                with open(os.path.join(dirpath, name), "r+b") as f:
                    f.truncate(12)
    assert tc.get(keys[0]) is None and jc.get(keys[0]) is None
    assert (set(tc.stats()) == set(jc.stats()))


def test_prewarm_plan_and_warm_match_jax(tmp_path):
    log = tmp_path / "events.jsonl"
    rng = np.random.default_rng(1)
    with open(log, "w") as f:
        for i in range(300):
            z = int(rng.integers(0, 4))
            path = f"/tiles/default/{z}/{int(rng.integers(0, 1 << z))}/0.png"
            status = 200 if i % 17 else 503
            f.write(json.dumps({"event": "http_request", "ts": float(i),
                                "route": "tiles", "status": status,
                                "path": path, "ms": 1.0,
                                "bytes": 10}) + "\n")
    for k, hl in ((5, 512.0), (40, 8.0)):
        got = prewarm.build_plan([str(log)], top_k=k, half_life=hl)
        assert got == jprewarm.build_plan([str(log)], top_k=k,
                                          half_life=hl)
    # warm() through both apps over one store: same keys and bytes.
    store = tmp_path / "lv"
    with topen_sink(f"arrays:{store}") as sink:
        tbatch.run_job(topen_source("synthetic:800:4"), sink,
                       tbatch.BatchJobConfig(**CFG), device="cpu")
    plan = prewarm.build_plan([str(log)], top_k=20)
    japp = JApp(JStore(f"arrays:{store}"), JCache())
    tapp = TApp(TStore(f"arrays:{store}"), TCache())
    js = jprewarm.warm(japp, plan)
    ts = prewarm.warm(tapp, plan)
    for k in js:
        if k != "seconds":
            assert ts[k] == js[k], k
    assert list(japp.cache._entries) == list(tapp.cache._entries)
