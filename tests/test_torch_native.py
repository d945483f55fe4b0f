"""The port's bindings to the native runtime library on the CPU:
``decode_keys``, ``format_blob_ids`` and ``format_blob_bodies`` equal to
the numpy path and to the JAX package's bindings; the cascade's egress
through them equal to its numpy egress (and to the numpy path beside the
int32-slot guard); the ``TS_MISSING`` agreement; the CSV decoder; the
staging pool; and the locked build, which parallel first users run
once."""

import importlib
import json
import os
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest

from heatmap_tpu import native as jnative
from heatmap_tpu.pipeline.timespan import TS_MISSING as JAX_TS_MISSING
from heatmap_tpu_torch import native
from heatmap_tpu_torch.pipeline import cascade as tcascade
from heatmap_tpu_torch.pipeline.timespan import TS_MISSING
from heatmap_tpu_torch.tilemath import morton

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    """The JAX reference's bindings, loaded. heatmap_tpu.native builds at
    import without a lock, so under ``pytest -n`` on a fresh checkout a
    worker can lose that race and import it without its library; it
    then loads the port's locked build (``HEATMAP_TPU_NATIVE_LIB``)."""
    if jnative._lib is None:
        path = native.build()
        assert path, "the native library does not build"
        os.environ["HEATMAP_TPU_NATIVE_LIB"] = path
        importlib.reload(jnative)
    assert jnative.available()


def test_available_and_ts_missing_agree():
    assert native.available()
    lib = native._library()
    assert int(lib.hm_ts_missing()) == int(TS_MISSING) == int(JAX_TS_MISSING)


@pytest.mark.parametrize("code_bits", [10, 30, 42])
def test_decode_keys_equal_numpy_and_jax(code_bits):
    rng = np.random.default_rng(code_bits)
    slots = rng.integers(0, 1 << 20, 70_000)
    codes = rng.integers(0, 1 << code_bits, 70_000)
    keys = ((slots << code_bits) | codes).astype(np.int64)
    slot, code, row, col = native.decode_keys(keys, code_bits)
    assert slot.dtype == np.int32 and code.dtype == np.int64
    assert row.dtype == col.dtype == np.int32
    k = keys.astype(np.int64)
    want_code = k & ((1 << code_bits) - 1)
    np.testing.assert_array_equal(code, want_code)
    np.testing.assert_array_equal(slot, k >> code_bits)
    wr, wc = morton._morton_decode_np_pure(want_code)
    np.testing.assert_array_equal(row, wr)
    np.testing.assert_array_equal(col, wc)
    for got, want in zip(native.decode_keys(keys, code_bits),
                         jnative.decode_keys(keys, code_bits)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    _, _, r2, c2 = native.decode_keys(keys, code_bits, morton_only=True)
    np.testing.assert_array_equal(r2, row)
    with pytest.raises(ValueError, match="1-D"):
        native.decode_keys(keys.reshape(2, -1), code_bits)


def test_morton_decode_np_native_route_equal_pure():
    codes = np.random.default_rng(1).integers(0, 1 << 42, 200_001)
    for got, want in zip(morton.morton_decode_np(codes),
                         morton._morton_decode_np_pure(codes)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _level(n=5000, seed=0, fractional=False):
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, 1 << 21, n)).astype(np.int32)
    col = rng.integers(0, 1 << 21, n).astype(np.int32)
    value = (rng.random(n) * 1e3 if fractional
             else rng.integers(1, 10_000, n).astype(np.float64))
    is_start = np.zeros(n, bool)
    is_start[0] = True
    is_start[rng.integers(1, n, n // 10)] = True
    return row, col, value, is_start


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_format_blob_bodies_equal_numpy_and_jax(seed, monkeypatch):
    row, col, value, is_start = _level(seed=seed)
    lvl = {"row": row, "col": col, "value": value, "zoom": 21}
    got = native.format_blob_bodies(row, col, value, is_start, 21)
    assert got == jnative.format_blob_bodies(row, col, value, is_start, 21)
    monkeypatch.setattr(native, "available", lambda: False)
    want = tcascade._blob_bodies(lvl, is_start)
    assert got == want
    assert all(json.loads(d) for d in got)
    assert native.format_blob_bodies([], [], [], [], 21) == []


@pytest.mark.parametrize("seed", [0, 1])
def test_format_blob_ids_equal_numpy_and_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    n = 3000
    users = np.array(["all", "user-1", "route", "ünï"])
    tss = np.array(["alltime", "2017-07"])
    ui = rng.integers(0, len(users), n).astype(np.int32)
    ti = rng.integers(0, len(tss), n).astype(np.int32)
    cr = rng.integers(0, 1 << 16, n).astype(np.int32)
    cc = rng.integers(0, 1 << 16, n).astype(np.int32)
    got = native.format_blob_ids(ui, ti, cr, cc, 16, users, tss)
    assert got == jnative.format_blob_ids(ui, ti, cr, cc, 16, users, tss)
    want = [f"{users[u]}|{tss[t]}|16_{r}_{c}"
            for u, t, r, c in zip(ui, ti, cr, cc)]
    assert got == want
    with pytest.raises(ValueError, match="out of range"):
        native.format_blob_ids(ui, ti, cr, cc, 16, users[:1], tss)
    with pytest.raises(ValueError, match="length mismatch"):
        native.format_blob_ids(ui[:5], ti, cr, cc, 16, users, tss)


@pytest.mark.parametrize("fractional", [False, True])
def test_cascade_egress_native_equal_numpy(monkeypatch, fractional):
    """decode_levels + json_blobs_from_level_arrays through the native
    library equal the numpy path on the same cascade (fractional sums
    take the numpy formatter either way)."""
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

    def egress():
        decoded = tcascade.decode_levels(levels, ccfg)
        fin = tcascade.finalize_level_arrays(decoded, ccfg, names)
        return decoded, tcascade.json_blobs_from_level_arrays(fin)

    decoded, got = egress()
    monkeypatch.setattr(native, "available", lambda: False)
    decoded_np, want = egress()
    assert len(want) > 100 and got == want
    for a, b in zip(decoded, decoded_np):
        for k in ("slot", "code", "row", "col", "value"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["slot"].dtype == np.int32 and b["slot"].dtype == np.int64


def test_decode_levels_int32_slot_guard():
    """A level whose slots pass int32 (code_bits < 33) decodes through
    numpy, with int64 slots, never wrapped."""
    import torch

    ccfg = tcascade.CascadeConfig(detail_zoom=12, min_detail_zoom=10)
    keys = torch.tensor([(1 << 35) << 24 | 5, (1 << 35) << 24 | 9])
    level = (keys, torch.tensor([1, 2], dtype=torch.int32),
             torch.tensor(2, dtype=torch.int32))
    out = tcascade.decode_levels([level, level], ccfg)
    assert out[0]["slot"].dtype == np.int64
    np.testing.assert_array_equal(out[0]["slot"], [1 << 35, 1 << 35])
    np.testing.assert_array_equal(out[0]["code"], [5, 9])


@pytest.mark.parametrize("fast", [False, True])
def test_parse_csv_batches_equal_jax(tmp_path, fast):
    path = tmp_path / "p.csv"
    rng = np.random.default_rng(2)
    lines = ["latitude,longitude,user_id,source,timestamp"]
    for i in range(2500):
        user = ("x-1", "rt-4", f"user-{i % 7}")[i % 3]
        ts = "" if i % 97 == 0 else str(1_500_000_000_000 + i)
        lines.append(f"{rng.uniform(-80, 80)!r},{rng.uniform(-180, 180)!r},"
                     f"{user},{'background' if i % 11 == 0 else 'gps'},{ts}")
    path.write_text("\n".join(lines) + "\n")
    got = list(native.parse_csv_batches(str(path), 700, fast=fast,
                                        n_workers=1))
    want = list(jnative.parse_csv_batches(str(path), 700, fast=fast,
                                          n_workers=1))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    assert list(native.parse_csv_batches(str(empty), 10)) == []
    bad = tmp_path / "bad.csv"
    bad.write_text("a,b\n1,2\n")
    with pytest.raises(ValueError, match="latitude/longitude"):
        list(native.parse_csv_batches(str(bad), 10))


def test_staging_pool():
    with native.StagingPool(1 << 12, n_bufs=2) as pool:
        assert pool.n_bufs == 2 and pool.buf_bytes >= 1 << 12
        a, arr = pool.acquire((16,), np.float64)
        arr[:] = np.arange(16)
        b, _ = pool.acquire((4,), np.int32)
        assert pool.acquire((4,), np.int32, block=False) is None
        with pytest.raises(RuntimeError, match="still acquired"):
            pool.close()
        pool.release(a)
        pool.release(b)
        with pytest.raises(ValueError, match="bytes"):
            pool.acquire((1 << 20,), np.float64)


def test_locked_build_runs_once_under_parallel_first_users(tmp_path):
    """Four processes that build the library at once compile it once,
    and each loads it."""
    src = tmp_path / "native"
    src.mkdir()
    for name in os.listdir(os.path.join(REPO, "native")):
        if name.endswith(".cpp") or name == "Makefile":
            shutil.copy(os.path.join(REPO, "native", name), src / name)
    count = tmp_path / "compiles"
    cxx = tmp_path / "cxx.sh"
    cxx.write_text(f"#!/bin/sh\necho x >> {count}\nexec g++ \"$@\"\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    out = tmp_path / "out"
    code = ("import ctypes, sys; from heatmap_tpu_torch import native; "
            "p = native.build(sys.argv[1], sys.argv[2]); "
            "assert p, 'build failed'; ctypes.CDLL(p).hm_ts_missing")
    env = dict(os.environ, CXX=str(cxx))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src),
                               str(out)],
                              cwd=REPO, env=env, stderr=subprocess.PIPE)
             for _ in range(4)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errs
    assert count.read_text().split() == ["x"]
    assert (out / native.LIB_NAME).exists()
    assert not (src / "build").exists()
    # No toolchain sources: no library, and no exception.
    assert native.build(str(tmp_path / "missing")) is None
