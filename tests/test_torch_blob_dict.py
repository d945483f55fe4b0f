"""The one-pass blob dict builder (``csrc/blob_dict.cpp``,
``pipeline/blob_dict.py``) on the CPU: the job's ``{blob_id: json}`` dict
equal, key order included, to the JAX package's per-level native
formatters joined by ``dict.update`` and to the numpy oracle; its reference counts, its memory
over repeated calls and its refusals; and the ``g++`` route of
``_build`` that builds it (hash-named, cached, rebuilt on an edit, built
once by parallel first users)."""

import ctypes
import hashlib
import importlib
import json
import os
import pathlib
import stat
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest

from heatmap_tpu import native as jnative
from heatmap_tpu_torch import _build, native
from heatmap_tpu_torch.pipeline import blob_dict
from heatmap_tpu_torch.pipeline import cascade as tcascade

REPO = pathlib.Path(__file__).resolve().parent.parent
USERS = np.array(["all", "user-1", "rt-4", "ünï", "用户-é", "🗺-x"])
TIMESPANS = np.array(["alltime", "2017-07", "2017-07-04"])


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    """The JAX package's formatters, loaded. heatmap_tpu.native builds at
    import without a lock, so under ``pytest -n`` on a fresh checkout a
    worker can lose that race and import it without its library; it
    then loads the port's locked build (``HEATMAP_TPU_NATIVE_LIB``)."""
    if jnative._lib is None:
        path = native.build()
        assert path, "the native library does not build"
        os.environ["HEATMAP_TPU_NATIVE_LIB"] = path
        importlib.reload(jnative)
    assert jnative.available()


def _level(n, zoom=14, delta=5, seed=0, users=USERS, tss=TIMESPANS,
           values=None, one_blob=False, corner=False):
    """A finalized level (``cascade.finalize_level_arrays``'s columns) of
    ``n`` distinct entries, sorted so that blob runs are contiguous."""
    rng = np.random.default_rng(seed)
    hi = 1 << zoom
    if one_blob:
        u = np.zeros(n, np.int64)
        t = np.zeros(n, np.int64)
        side = min(hi, 1 << delta)
        cell = rng.permutation(side * side)[:n]
        row, col = cell // side, cell % side
    elif corner:
        u = rng.integers(0, len(users), n)
        t = rng.integers(0, len(tss), n)
        row = np.full(n, hi - 1)
        col = np.full(n, hi - 1)
    else:
        u = rng.integers(0, len(users), n)
        t = rng.integers(0, len(tss), n)
        row = rng.integers(0, hi, n)
        col = rng.integers(0, hi, n)
    slot = u * len(tss) + t
    order = np.lexsort((col, row, col >> delta, row >> delta, slot))
    key = np.stack([slot, row, col])[:, order]
    keep = np.concatenate([[True], np.any(key[:, 1:] != key[:, :-1], 0)])
    order = order[keep]
    m = len(order)
    if values is None:
        value = rng.integers(1, 10_000, m).astype(np.float64)
    else:
        value = np.resize(np.asarray(values, np.float64), m)
    row32 = row[order].astype(np.int32)
    col32 = col[order].astype(np.int32)
    return {
        "zoom": zoom, "slot": slot[order].astype(np.int32),
        "code": np.zeros(m, np.int64), "row": row32, "col": col32,
        "value": value,
        "user_idx": u[order].astype(np.int32),
        "timespan_idx": t[order].astype(np.int32),
        "user_names": users, "timespan_names": tss,
        "coarse_zoom": zoom - delta, "coarse_row": row32 >> delta,
        "coarse_col": col32 >> delta,
    }


def _starts(lvl):
    slots, cr, cc = lvl["slot"], lvl["coarse_row"], lvl["coarse_col"]
    is_start = np.concatenate([[True], (slots[1:] != slots[:-1])
                               | (cr[1:] != cr[:-1]) | (cc[1:] != cc[:-1])])
    return is_start, np.flatnonzero(is_start)


def _integral(lvl):
    v = lvl["value"]
    return bool(np.all((v == np.floor(v)) & (np.abs(v) < 1e15)))


def _per_level_update(levels):
    """The egress before the one-pass dict: the JAX package's native id and
    body formatters per level (numpy bodies for fractional sums), joined
    by ``dict.update``."""
    out = {}
    for lvl in levels:
        if len(lvl["slot"]) == 0:
            continue
        is_start, sidx = _starts(lvl)
        ids = jnative.format_blob_ids(
            lvl["user_idx"][sidx], lvl["timespan_idx"][sidx],
            lvl["coarse_row"][sidx], lvl["coarse_col"][sidx],
            int(lvl["coarse_zoom"]), lvl["user_names"],
            lvl["timespan_names"])
        if _integral(lvl):
            bodies = jnative.format_blob_bodies(
                lvl["row"], lvl["col"], lvl["value"], is_start,
                int(lvl["zoom"]))
        else:
            bodies = tcascade._blob_bodies(lvl, is_start)
        out.update(zip(ids, bodies))
    return out


def _cascade_levels(fractional):
    """The two cascades of test_torch_native's
    ``test_cascade_egress_native_equal_numpy``, finalized."""
    import torch

    rng = np.random.default_rng(3)
    n, n_slots = 4000, 6
    ccfg = tcascade.CascadeConfig(detail_zoom=14, min_detail_zoom=6)
    codes = torch.as_tensor(rng.integers(0, 1 << 28, n))
    slots = torch.as_tensor(rng.integers(0, n_slots, n))
    weights = torch.as_tensor(rng.random(n) * 10 if fractional
                              else rng.integers(0, 50, n).astype(np.float64))
    levels = tcascade.run_cascade(codes, slots, ccfg, n_slots=n_slots,
                                  capacity=n, weights=weights,
                                  acc_dtype=torch.float64)
    names = {s: (("all", "u1", "u2")[s % 3], ("alltime", "2020")[s // 3])
             for s in range(n_slots)}
    return tcascade.finalize_level_arrays(
        tcascade.decode_levels(levels, ccfg), ccfg, names)


def _empty(lvl):
    return {k: (v[:0] if isinstance(v, np.ndarray) and v.ndim and
                k not in ("user_names", "timespan_names") else v)
            for k, v in lvl.items()}


CASES = {
    "no_levels": lambda: [],
    "empty_level_among_full": lambda: [
        _level(400, zoom=12, seed=1), _empty(_level(10, zoom=11)),
        _level(600, zoom=10, seed=2)],
    "one_entry": lambda: [_level(1, seed=3)],
    "one_blob_whole_level": lambda: [_level(700, one_blob=True, seed=4)],
    "more_threads_than_blobs": lambda: [
        _level(5, one_blob=True, seed=5), _level(2, zoom=9, seed=6)],
    "straddling_slices": lambda: [
        _level(3000, zoom=8, delta=2, seed=s) for s in (7, 8, 9)],
    "values_0_1_max": lambda: [
        _level(900, seed=10, values=[0, 1, 999_999_999_999_999])],
    "zoom_0_and_21_corner": lambda: [
        _level(1, zoom=0, delta=0, seed=11),
        _level(40, zoom=21, corner=True, seed=12)],
    "non_ascii_names": lambda: [
        _level(2000, seed=13, users=np.array(["ünï", "用户-é"])),
        _level(500, zoom=13, seed=14)],
    "cascade_counts": lambda: _cascade_levels(False),
    "cascade_fractional": lambda: _cascade_levels(True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_builder_equal_per_level_update_and_numpy(case, monkeypatch):
    levels = CASES[case]()
    assert native.available() and blob_dict.available()
    got = tcascade.json_blobs_from_level_arrays(levels)
    want = _per_level_update(levels)
    assert got == want and list(got) == list(want)
    runs = [(lvl, _starts(lvl)[1]) for lvl in levels if len(lvl["slot"])]
    if all(_integral(lvl) for lvl, _ in runs):
        for n_threads in (1, 2, 3, 5, 8, 64):
            direct = blob_dict.build(runs, n_threads=n_threads)
            assert direct == want and list(direct) == list(want)
    for key, body in got.items():
        assert hash(key) == hash(key.encode().decode())
        json.loads(body)
    monkeypatch.setattr(native, "available", lambda: False)
    oracle = tcascade.json_blobs_from_level_arrays(levels)
    assert oracle == got and list(oracle) == list(got)


def test_builder_writes_signed_values_as_json_dumps():
    """Negative sums and -0.0 come out as ``json.dumps`` writes them."""
    lvl = _level(300, seed=15, values=[-0.0, -1, -999_999_999_999_999, 7])
    got = blob_dict.build([(lvl, _starts(lvl)[1])])
    want = {k: json.dumps(v) for k, v in
            tcascade.blobs_from_level_arrays([lvl]).items()}
    assert got == want
    assert any('": -0.0' in b for b in got.values())


def _python_built(lvl):
    """The same dict made in Python from split text."""
    is_start, sidx = _starts(lvl)
    ids = "\x00".join(tcascade.level_strings(lvl, sidx)[0] + "|" +
                      tcascade.level_strings(lvl, sidx)[1] + "|" +
                      tcascade._tile_id_strings(
                          lvl["coarse_zoom"], lvl["coarse_row"][sidx],
                          lvl["coarse_col"][sidx])).split("\x00")
    return dict(zip(ids, tcascade._blob_bodies(lvl, is_start)))


def test_reference_counts_equal_a_python_built_dict():
    lvl = _level(800, seed=16)
    got = blob_dict.build([(lvl, _starts(lvl)[1])])
    want = _python_built(lvl)
    assert got == want
    assert sys.getrefcount(got) == sys.getrefcount(want)
    k, kw = next(iter(got)), next(iter(want))
    assert sys.getrefcount(k) == sys.getrefcount(kw)
    v, vw = got[k], want[kw]
    assert sys.getrefcount(v) == sys.getrefcount(vw)
    assert type(k) is type(v) is str


def test_repeated_calls_leave_traced_memory_flat():
    lvl = _level(3000, seed=17)
    bad = dict(lvl, user_idx=np.full_like(lvl["user_idx"], len(USERS)))
    runs, bad_runs = [(lvl, _starts(lvl)[1])], [(bad, _starts(bad)[1])]
    tracemalloc.start()
    try:
        for _ in range(5):
            blob_dict.build(runs)
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(50):
            blob_dict.build(runs)
            with pytest.raises(ValueError):
                blob_dict.build(bad_runs)
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before < 64 << 10


def test_bad_index_or_start_raises_and_returns_nothing():
    lvl = _level(500, seed=18)
    sidx = _starts(lvl)[1]
    bad = dict(lvl, user_idx=lvl["user_idx"].copy())
    bad["user_idx"][sidx[-1]] = len(USERS)
    out = {"kept": "{}"}
    with pytest.raises(ValueError, match="out of range"):
        blob_dict.build([(lvl, sidx), (bad, sidx)], out)
    assert out == {"kept": "{}"}
    with pytest.raises(ValueError, match="out of range"):
        tcascade.json_blobs_from_level_arrays([bad])
    with pytest.raises(ValueError, match="starts"):
        blob_dict.build([(lvl, sidx[1:])])
    with pytest.raises(ValueError, match="length mismatch"):
        blob_dict.build([(dict(lvl, value=lvl["value"][1:]), sidx)])
    got = blob_dict.build([(lvl, sidx)], out)
    assert got is out and list(out)[0] == "kept"
    assert len(out) == 1 + len(sidx)


def test_library_forced_away_takes_numpy_with_the_same_dict(monkeypatch):
    levels = [_level(1500, seed=19), _level(900, zoom=12, seed=20)]
    f = tcascade.json_blobs_from_level_arrays
    monkeypatch.setattr(f, "dict_blobs", 0)
    monkeypatch.setattr(f, "numpy_blobs", 0)
    got = f(levels)
    assert (f.dict_blobs, f.numpy_blobs) == (len(got), 0)
    assert tcascade.egress_path() == "dict"
    monkeypatch.setattr(blob_dict, "available", lambda: False)
    want = f(levels)
    assert want == got and list(want) == list(got)
    assert (f.dict_blobs, f.numpy_blobs) == (len(got), len(got))
    assert tcascade.egress_path() == "numpy"


def test_mixed_levels_keep_level_order():
    """A fractional level between integral ones goes to numpy; the dict
    keeps level order across the three."""
    frac = _level(400, zoom=12, seed=22)
    frac["value"] = frac["value"] + 0.25
    levels = [_level(600, seed=21), frac, _level(300, zoom=11, seed=23)]
    got = tcascade.json_blobs_from_level_arrays(levels)
    want = _per_level_update(levels)
    assert got == want and list(got) == list(want)
    assert tcascade.egress_path() == "dict+numpy"


# ---- the g++ route of _build ------------------------------------------------

TINY = """#include <Python.h>
#define VALUE {value}
extern "C" PyObject* hm_tiny(void) {{ return PyLong_FromLong(VALUE); }}
"""


def _counting_cxx(tmp_path):
    count = tmp_path / "compiles"
    cxx = tmp_path / "cxx.sh"
    cxx.write_text(f"#!/bin/sh\necho x >> {count}\nexec g++ \"$@\"\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    return cxx, count


def _tiny_value(lib):
    fn = lib.hm_tiny
    fn.restype = ctypes.py_object
    return fn()


@pytest.fixture
def tiny_csrc(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "tiny.cpp").write_text(TINY.format(value=7))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    _build.load_host.cache_clear()
    yield csrc, build
    _build.load_host.cache_clear()


def test_host_library_named_by_source_and_flags(tiny_csrc):
    csrc, build = tiny_csrc
    h = hashlib.sha256(" ".join(_build._host_flags()).encode())
    h.update(b"tiny.cpp")
    h.update((csrc / "tiny.cpp").read_bytes())
    path = _build._library_path("tiny", ".cpp")
    assert path == build / f"libtiny-{h.hexdigest()[:16]}.so"
    assert any(f.startswith("-I") and os.path.isfile(
        os.path.join(f[2:], "Python.h")) for f in _build._host_flags())
    assert "tiny" not in _build.sources()


def test_host_library_cached_and_rebuilt_on_edit(tiny_csrc, tmp_path,
                                                 monkeypatch):
    csrc, build = tiny_csrc
    cxx, count = _counting_cxx(tmp_path)
    monkeypatch.setenv("CXX", str(cxx))
    assert _tiny_value(_build.load_host("tiny")) == 7
    _build.load_host.cache_clear()
    assert _tiny_value(_build.load_host("tiny")) == 7
    assert count.read_text().split() == ["x"]
    (csrc / "tiny.cpp").write_text(TINY.format(value=8))
    _build.load_host.cache_clear()
    assert _tiny_value(_build.load_host("tiny")) == 8
    assert count.read_text().split() == ["x", "x"]
    assert len(list(build.glob("libtiny-*.so"))) == 2
    assert not list(build.glob("*.tmp"))


def test_host_build_runs_once_under_parallel_first_users(tiny_csrc,
                                                          tmp_path):
    csrc, build = tiny_csrc
    cxx, count = _counting_cxx(tmp_path)
    code = ("import ctypes, pathlib, sys; from heatmap_tpu_torch import "
            "_build; _build.CSRC = pathlib.Path(sys.argv[1]); "
            "_build.BUILD_DIR = pathlib.Path(sys.argv[2]); "
            "f = _build.load_host('tiny').hm_tiny; "
            "f.restype = ctypes.py_object; assert f() == 7")
    env = dict(os.environ, CXX=str(cxx))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(csrc),
                               str(build)],
                              cwd=REPO, env=env, stderr=subprocess.PIPE)
             for _ in range(4)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errs
    assert count.read_text().split() == ["x"]
