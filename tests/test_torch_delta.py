"""The port's delta store (heatmap_tpu_torch.delta) on the CPU against the
JAX package's: content hashes, entry digests, journal entries and config
fingerprints; delta artifacts and the compacted base, synopsis and
integral files byte for byte; stores continued across packages with
duplicates detected; retractions (signed and by predicate) converging to
a clean recompute; the recovery sweep; and the refusals of what waits
for later slices. Detail zoom 12 on small seeded sources."""

import json
import os
import shutil

import numpy as np
import pytest

from heatmap_tpu import delta as jdelta
from heatmap_tpu.analytics import integral as jintegral
from heatmap_tpu.delta.compact import (
    config_fingerprint as jconfig_fingerprint)
from heatmap_tpu.delta import journal as jjournal
from heatmap_tpu.delta import recover as jrecover
from heatmap_tpu.delta.compute import affected_tile_keys as jaffected
from heatmap_tpu.io.sinks import LevelArraysSink as JaxLevelArraysSink
from heatmap_tpu.io.sources import SyntheticSource as JaxSyntheticSource
from heatmap_tpu.pipeline import batch as jbatch
from heatmap_tpu.synopsis import build as jsynopsis
from heatmap_tpu_torch import delta
from heatmap_tpu_torch.analytics import integral
from heatmap_tpu_torch.delta import journal, recover
from heatmap_tpu_torch.delta.compact import (config_fingerprint,
                                             drop_zero_rows, read_current,
                                             write_current)
from heatmap_tpu_torch.io import LevelArraysSink, SyntheticSource
from heatmap_tpu_torch.pipeline import batch as tbatch
from heatmap_tpu_torch.synopsis import build as synopsis
from heatmap_tpu_torch.temporal import fold as tfold
from heatmap_tpu_torch.utils.checkpoint import load_checkpoint

CFG = dict(detail_zoom=12, timespans=("alltime", "month"))


@pytest.fixture(autouse=True)
def _clear_sweep_cache():
    yield
    recover.clear_verified_cache()


def _cfg(pkg, **kw):
    mod = tbatch if pkg == "torch" else jbatch
    return mod.BatchJobConfig(**{**CFG, **kw})


def _pkg(pkg):
    """(delta package, synthetic source class, apply kwargs)."""
    if pkg == "torch":
        return delta, SyntheticSource, {"device": "cpu"}
    return jdelta, JaxSyntheticSource, {}


def _cols(seed, n, weighted=False):
    """Seeded point columns with a value column when ``weighted``."""
    cols = delta.read_columns(SyntheticSource(n=n, seed=seed))
    if weighted:
        rng = np.random.default_rng(seed)
        cols["value"] = rng.integers(0, 50, n).astype(np.float64)
    return cols


def _tree(root):
    """{relative path: bytes} of every file under ``root``, journal
    entries as their arrays and meta without the wall-clock ``ts``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if rel.startswith("journal" + os.sep):
                arrays, meta = load_checkpoint(full)
                meta.pop("ts")
                out[rel] = (json.dumps(meta, sort_keys=True),
                            {k: v.tolist() for k, v in arrays.items()})
            else:
                with open(full, "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.mark.parametrize("sign,salt", [(1, None), (-1, None),
                                       (-1, "watermark=1510939018.0")])
def test_hash_digest_entry_equal_jax(tmp_path, sign, salt):
    cols = delta.read_columns(SyntheticSource(n=900, seed=5))
    jcols = jdelta.read_columns(JaxSyntheticSource(n=900, seed=5))
    assert cols.keys() == jcols.keys()
    h = journal.batch_content_hash(cols, sign=sign, salt=salt)
    assert h == jjournal.batch_content_hash(jcols, sign=sign, salt=salt)
    art = tmp_path / "delta-000001"
    art.mkdir()
    (art / "level_z12.npz").write_bytes(b"abc")
    kw = dict(content_hash=h, sign=sign, points=900, artifact=art.name)
    assert (journal.entry_digest(str(tmp_path), **kw)
            == jjournal.entry_digest(str(tmp_path), **kw))
    enc, jenc = journal.encode_points(cols), jjournal.encode_points(jcols)
    assert enc.keys() == jenc.keys()
    for k in enc:
        np.testing.assert_array_equal(enc[k], jenc[k])
    dec, jdec = journal.decode_points(enc), jjournal.decode_points(jenc)
    assert dec.keys() == jdec.keys()
    for k in dec:
        assert list(dec[k]) == list(jdec[k])
    for pkg, jmod in (("t", journal), ("j", jjournal)):
        j = jmod.DeltaJournal(str(tmp_path / pkg / "journal"))
        meta = j.append(content_hash=h, points=900, sign=sign,
                        artifact=art.name, watermark=5.0, cols=cols)
        assert j.append(content_hash=h, points=1, sign=sign,
                        artifact="x", cols=cols) == meta  # idempotent
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


@pytest.mark.parametrize("n,timespans", [(1, ("alltime",)),
                                         (2500, ("alltime", "month"))])
def test_affected_tile_keys_equal_jax(tmp_path, n, timespans):
    """The port's key set equals the JAX package's set: length, every
    member, iteration; no key outside it is a member."""
    out = str(tmp_path / "lv")
    tbatch.run_job(SyntheticSource(n=n, seed=9), LevelArraysSink(out),
                   _cfg("torch", timespans=timespans), device="cpu")
    levels = LevelArraysSink.load(out)
    got, want = delta.affected_tile_keys(levels), jaffected(levels)
    assert len(got) == len(want) and set(got) == want
    assert all(k in got for k in want)
    nm, z, x, y, fmt = next(iter(want))
    for miss in ((nm, z, x, y, "gif"), ("nobody", z, x, y, fmt),
                 (nm, z + 40, x, y, fmt), (nm, z, x + (1 << 30), y, fmt),
                 "not-a-key"):
        assert miss not in got and miss not in want
    assert len(delta.affected_tile_keys({})) == 0 == len(jaffected({}))


@pytest.mark.parametrize("kw", [{}, {"weighted": True},
                                {"timespans": ("alltime", "day", "year")}])
def test_config_fingerprint_equal_jax(kw):
    got = config_fingerprint(_cfg("torch", **kw))
    assert got == jconfig_fingerprint(_cfg("jax", **kw))


def _sequence(pkg, root, weighted=False):
    """Base, two increments, a duplicate, a signed retraction, one
    compaction, then one more increment; the DeltaResults in order."""
    dmod, _, kw = _pkg(pkg)
    cfg = _cfg(pkg, weighted=weighted)
    out = []
    for seed, n, sign in ((0, 3000, 1), (1, 500, 1), (2, 500, 1),
                          (2, 500, 1), (1, 500, -1)):
        out.append(dmod.apply_batch(
            root, dmod.ColumnsSource(_cols(seed, n, weighted)), cfg,
            sign=sign, **kw))
    out.append(dmod.compact(root, retention=2))
    out.append(dmod.apply_batch(
        root, dmod.ColumnsSource(_cols(3, 400, weighted)), cfg, **kw))
    return out


@pytest.mark.parametrize("weighted", [False, True])
def test_store_sequence_equal_jax(tmp_path, weighted):
    """Every artifact of the same sequence is the JAX package's: delta
    dirs, the compacted base with its synopses and integrals, CURRENT,
    and the journal entries."""
    got = _sequence("torch", str(tmp_path / "t"), weighted)
    want = _sequence("jax", str(tmp_path / "j"), weighted)
    for a, b in zip(got, want):
        if isinstance(a, dict):
            assert {k: v for k, v in a.items() if k != "seconds"} == {
                k: v for k, v in b.items() if k != "seconds"}
        else:
            assert (a.epoch, a.points, a.sign, a.duplicate, a.artifact,
                    a.rows, a.affected_keys) == (
                b.epoch, b.points, b.sign, b.duplicate, b.artifact,
                b.rows, b.affected_keys)
    assert [r.duplicate for r in got[:5]] == [False] * 3 + [True, False]
    tree = _tree(tmp_path / "t")
    assert any(k.startswith("base-000004/synopsis-z") for k in tree)
    assert any(k.startswith("base-000004/integral-z") for k in tree)
    assert tree == _tree(tmp_path / "j")
    levels = delta.load_overlay_levels(str(tmp_path / "t"))
    want_levels = jdelta.load_overlay_levels(str(tmp_path / "j"))
    assert len(levels) == len(want_levels)
    for a, b in zip(levels, want_levels):
        for k in LevelArraysSink.COLUMNS:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_store_continues_across_packages(tmp_path, first):
    """A store started by one package continues in the other: its config
    passes, a batch it journaled is a duplicate (same epoch, no new
    artifact), and compaction gives the same base as either package
    alone."""
    second = "torch" if first == "jax" else "jax"
    mixed, alone = str(tmp_path / "mixed"), str(tmp_path / "alone")
    steps = [(first, 0, 2000), (first, 1, 400), (second, 1, 400),
             (second, 2, 400)]
    results = []
    for pkg, seed, n in steps:
        dmod, _, kw = _pkg(pkg)
        results.append(dmod.apply_batch(
            mixed, dmod.ColumnsSource(_cols(seed, n)), _cfg(pkg), **kw))
    assert results[2].duplicate and results[2].epoch == 2
    assert not os.path.exists(os.path.join(mixed, "delta-000004"))
    assert results[3].epoch == 3
    _pkg(second)[0].compact(mixed, retention=1)
    for seed, n in ((0, 2000), (1, 400), (2, 400)):
        jdelta.apply_batch(alone, jdelta.ColumnsSource(_cols(seed, n)),
                           _cfg("jax"))
    jdelta.compact(alone, retention=1)
    assert _tree(mixed) == _tree(alone)
    with pytest.raises(ValueError, match="refusing to apply"):
        delta.apply_batch(mixed, delta.ColumnsSource(_cols(4, 50)),
                          _cfg("torch", detail_zoom=11), device="cpu")


def _recompute(points, tmp_path, name):
    """The port's one-shot job over ``points`` as level arrays."""
    out = str(tmp_path / name)
    tbatch.run_job(delta.ColumnsSource(points), LevelArraysSink(out),
                   _cfg("torch"), device="cpu")
    return LevelArraysSink.load(out)


def _cells(users, timespans, cols):
    return sorted(zip(np.asarray(users).tolist(),
                      np.asarray(timespans).tolist(),
                      np.asarray(cols["row"]).tolist(),
                      np.asarray(cols["col"]).tolist(),
                      np.asarray(cols["value"]).tolist()))


def _assert_levels_equal(got_levels, want):
    """The same cells at every zoom (the overlay orders rows by merged
    key, a job by its slot vocabulary)."""
    got = {int(lvl["zoom"]): lvl for lvl in drop_zero_rows(got_levels)}
    assert sorted(got) == sorted(want)
    for z, cols in want.items():
        g = got[z]
        assert _cells(np.asarray(g["user_names"])[g["user_idx"]],
                      np.asarray(g["timespan_names"])[g["timespan_idx"]],
                      g) == _cells(cols["user"], cols["timespan"], cols)


def test_signed_and_predicate_retraction_converge(tmp_path):
    """Retracting a batch with sign=-1 and then a user by predicate
    leaves exactly the clean recompute over the surviving points, before
    and after compaction, and a second identical retraction is a no-op."""
    root = str(tmp_path / "store")
    cfg = _cfg("torch")
    for seed, n, sign in ((0, 3000, 1), (1, 600, 1), (1, 600, -1)):
        delta.apply_batch(root, delta.ColumnsSource(_cols(seed, n)), cfg,
                          sign=sign, device="cpu")
    base = _cols(0, 3000)
    _assert_levels_equal(delta.load_overlay_levels(root),
                         _recompute(base, tmp_path, "r0"))
    summary = delta.retract_predicate(root, delta.parse_where(
        ["user=user-3"]), device="cpu")
    keep = np.asarray([u != "user-3" for u in base["user_id"]])
    assert summary["rows"] == int((~keep).sum()) > 0
    assert summary["batches"] == 1
    survivors = {k: (np.asarray(v)[keep] if isinstance(v, np.ndarray)
                     else [x for x, m in zip(v, keep) if m])
                 for k, v in base.items()}
    want = _recompute(survivors, tmp_path, "r1")
    _assert_levels_equal(delta.load_overlay_levels(root), want)
    again = delta.retract_predicate(root, {"user_id": "user-3"},
                                    device="cpu")
    assert again["rows"] == 0 and again["batches"] == 0
    delta.compact(root)
    _assert_levels_equal(delta.load_overlay_levels(root), want)


@pytest.fixture(scope="module")
def swept_store(tmp_path_factory):
    """A compacted base (with synopses and integrals) and one live delta:
    epochs 1-2 folded into base-000002, epoch 3 live."""
    src = str(tmp_path_factory.mktemp("sweep") / "src")
    cfg = _cfg("torch")
    for seed, n in ((0, 1500), (1, 300)):
        delta.apply_batch(src, delta.ColumnsSource(_cols(seed, n)), cfg,
                          device="cpu")
    delta.compact(src, retention=2)
    delta.apply_batch(src, delta.ColumnsSource(_cols(2, 300)), cfg,
                      device="cpu")
    recover.clear_verified_cache()
    return src


@pytest.mark.parametrize("damage", ["torn_entry", "artifact_bytes",
                                    "orphan_tmp", "orphan_artifact",
                                    "torn_synopsis", "torn_integral"])
def test_sweep_quarantines_like_jax(tmp_path, swept_store, damage):
    src = swept_store
    cfg = _cfg("torch")
    found = []
    for name, sweep in (("t", recover.sweep), ("j", jrecover.sweep)):
        root = tmp_path / name
        shutil.copytree(src, root)
        if damage == "torn_entry":
            p = root / "journal" / "ckpt-3.npz"
            p.write_bytes(p.read_bytes()[:100])
        elif damage == "artifact_bytes":
            p = root / "delta-000003" / "level_z12.npz"
            p.write_bytes(p.read_bytes() + b"x")
        elif damage == "orphan_tmp":
            (root / "base-000009.tmp").mkdir()
        elif damage == "orphan_artifact":
            shutil.copytree(root / "delta-000003", root / "delta-000007")
        else:
            kind = damage.split("_")[1]
            p = root / "base-000002" / f"{kind}-z08.npz"
            p.write_bytes(p.read_bytes()[:64])
        found.append(sorted((q["path"], q["reason"], q["kind"])
                            for q in sweep(str(root))["quarantined"]))
        assert sorted(os.listdir(root / "quarantine"))
    assert found[0] == found[1] and found[0]
    # The damaged batch re-applies cleanly under a fresh epoch.
    if damage in ("torn_entry", "artifact_bytes"):
        res = delta.apply_batch(str(tmp_path / "t"),
                                delta.ColumnsSource(_cols(2, 300)), cfg,
                                device="cpu")
        assert not res.duplicate and res.epoch == 3


@pytest.mark.parametrize("zoom_cut", [8, 10])
def test_synopsis_and_integral_files_equal_jax(tmp_path, zoom_cut):
    levels = _recompute(_cols(6, 2500), tmp_path, "lv")
    for pkg, syn, integ in (("t", synopsis, integral),
                            ("j", jsynopsis, jintegral)):
        d = tmp_path / pkg
        d.mkdir()
        s = syn.write_synopses(str(d), levels, max_z=zoom_cut)
        i = integ.write_integrals(str(d), levels, max_z=zoom_cut)
        assert s.keys() == i.keys() == {z for z in levels if z < zoom_cut}
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and names
    for n in names:
        a = tmp_path / "t" / n
        assert a.read_bytes() == (tmp_path / "j" / n).read_bytes(), n
        assert synopsis.verify_synopsis(str(a)) is None or n.startswith(
            "integral")
        assert integral.verify_integral(str(a)) is None or n.startswith(
            "synopsis")
        a.write_bytes(a.read_bytes()[:50])
        check = (synopsis.verify_synopsis if n.startswith("synopsis")
                 else integral.verify_integral)
        jcheck = (jsynopsis.verify_synopsis if n.startswith("synopsis")
                  else jintegral.verify_integral)
        assert check(str(a)) is not None
        assert check(str(a)) == jcheck(str(a))


def test_level_sink_side_artifacts_equal_jax(tmp_path):
    """``LevelArraysSink(synopses=True, integrals=True)`` writes the JAX
    sink's files."""
    src = SyntheticSource(n=2000, seed=8)
    tbatch.run_job(src, LevelArraysSink(str(tmp_path / "t"), synopses=True,
                                        integrals=True),
                   _cfg("torch"), device="cpu")
    jbatch.run_job(JaxSyntheticSource(n=2000, seed=8),
                   JaxLevelArraysSink(str(tmp_path / "j"), synopses=True,
                                      integrals=True), _cfg("jax"))
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert any(n.startswith("synopsis-") for n in names)
    for n in names:
        assert ((tmp_path / "t" / n).read_bytes()
                == (tmp_path / "j" / n).read_bytes()), n


def _store(tmp_path):
    root = str(tmp_path / "store")
    delta.apply_batch(root, delta.ColumnsSource(_cols(0, 800)),
                      _cfg("torch"), device="cpu")
    return root


def test_refusals_of_later_slices(tmp_path):
    """What earlier slices refused now works as in the JAX package. A
    store that pins a temporal config compacts into buckets and retracts
    per bucket, with the JAX store's bytes (temporal/); a stray buckets/
    dir in a base without a manifest is quarantined as an orphan by the
    sweep; a tilefs base and serving refresh work: a torn mirror is
    quarantined by the sweep, and a duplicate result publishes
    nothing."""
    root = _store(tmp_path)
    dup = delta.DeltaResult(epoch=1, points=0, sign=1, duplicate=True,
                            artifact=None, rows=0, seconds=0.0)
    assert delta.refresh_serving(dup, None) == 0
    jroot = str(tmp_path / "jstore")
    jdelta.apply_batch(jroot, jdelta.ColumnsSource(_cols(0, 800)),
                       _cfg("jax"))
    for r in (root, jroot):
        tfold.ensure_config(r, width=3600.0)
    comps = [delta.compact(root), jdelta.compact(jroot)]
    assert [c["buckets"] for c in comps] == [1, 1]
    sums = [delta.retract_predicate(root, {"user_id": "user-1"},
                                    device="cpu"),
            jdelta.retract_predicate(jroot, {"user_id": "user-1"})]
    assert sums[0]["rows"] == sums[1]["rows"] > 0
    assert sums[0]["batches"] == sums[1]["batches"] == 1
    assert _tree(root) == _tree(jroot)
    cur = read_current(root)
    write_current(root, {k: v for k, v in cur.items() if k != "temporal"})
    delta.compact(root)
    base = os.path.join(root, read_current(root)["base"])
    with open(os.path.join(base, "tilefs-z08.bin"), "wb") as f:
        f.write(b"\0" * 200 + b"TILEFSIX")
    delta.apply_batch(root, delta.ColumnsSource(_cols(1, 100)),
                      _cfg("torch"), device="cpu")
    assert not os.path.exists(os.path.join(base, "tilefs-z08.bin"))
    assert any("tilefs-z08.bin" in n
               for n in os.listdir(os.path.join(root, "quarantine")))
    assert delta.compact(root)["status"] == "ok"
    base = os.path.join(root, read_current(root)["base"])
    os.makedirs(os.path.join(base, "buckets", "bucket-0-3600"))
    jbase = os.path.join(jroot, read_current(jroot)["base"])
    os.makedirs(os.path.join(jbase, "buckets", "bucket-0-3600"))
    for sweep, r in ((delta.sweep, root), (jrecover.sweep, jroot)):
        items = sweep(r)["quarantined"]
        assert [(i["reason"], i["kind"]) for i in items] == [
            ("orphan_bucket", "temporal_bucket")]


def test_apply_needs_the_card_unless_asked(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        delta.apply_batch(str(tmp_path / "s"),
                          delta.ColumnsSource(_cols(0, 100)), _cfg("torch"))
    with pytest.raises(ValueError, match="sign"):
        delta.apply_batch(str(tmp_path / "s"),
                          delta.ColumnsSource(_cols(0, 100)), _cfg("torch"),
                          sign=2, device="cpu")
