"""The integer fast path, HMPB and checkpoint/resume on the CPU, held
against heatmap_tpu on the same seeded inputs: ``run_job_fast`` on CSV
files (native decoder) and HMPB files, dated timespans, weighted HMPB,
HMPB files byte-equal and readable across the two packages, the chunked
fast path, the fault-then-resume cycle of both resumable paths, resume
from a checkpoint the other package wrote, in both directions, and
every refusal. Blob dicts
are byte-identical; fractional weighted sums within ``rtol=1e-12``."""

import csv
import functools
import importlib
import json
import os

import numpy as np
import pytest

from heatmap_tpu.io import hmpb as jhmpb
from heatmap_tpu.io.sources import CSVSource as JaxCSVSource
from heatmap_tpu.io.sources import SyntheticSource as JaxSyntheticSource
from heatmap_tpu.pipeline import batch as jbatch
from heatmap_tpu.utils.recovery import FaultInjector as JaxFaultInjector
from heatmap_tpu_torch import native
from heatmap_tpu_torch.io import CSVSource, SyntheticSource
from heatmap_tpu_torch.io import hmpb as thmpb
from heatmap_tpu_torch.pipeline import batch as tbatch
from heatmap_tpu_torch.utils import FaultInjector


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    """The JAX reference with its native library. heatmap_tpu.native
    builds at import without a lock, so under ``pytest -n`` on a fresh
    checkout a worker can lose that race and import it without its
    library; it then loads the port's locked build instead (also what
    ``python -m heatmap_tpu`` subprocesses of this module load)."""
    from heatmap_tpu import native as jnative

    if jnative._lib is None:
        path = native.build()
        assert path, "the native library does not build"
        os.environ["HEATMAP_TPU_NATIVE_LIB"] = path
        importlib.reload(jnative)
    assert jnative.available()

N = 1500
SMALL = {"detail_zoom": 12, "min_detail_zoom": 6}
DATED = dict(SMALL, timespans=("alltime", "month", "day"))


def write_csv(path, n=N, seed=5, values=None, missing_ts=False):
    """The synthetic stream as a CSV file, timestamps in epoch ms;
    ``values`` "integer" or "fractional" adds a value column."""
    rows = list(JaxSyntheticSource(n=n, seed=seed).rows())
    rng = np.random.default_rng(seed)
    header = ["latitude", "longitude", "user_id", "source", "timestamp"]
    if values:
        header.append("value")
        vals = (rng.random(len(rows)) * 10 if values == "fractional"
                else rng.integers(0, 101, len(rows)))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i, r in enumerate(rows):
            ts = "" if missing_ts and i % 50 == 7 else r["timestamp"] * 1000
            line = [repr(r["latitude"]), repr(r["longitude"]), r["user_id"],
                    r["source"], ts]
            if values:
                line.append(repr(float(vals[i])))
            w.writerow(line)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fast")
    return {
        "csv": write_csv(d / "pts.csv"),
        "int_csv": write_csv(d / "int.csv", values="integer"),
        "frac_csv": write_csv(d / "frac.csv", values="fractional"),
        "missing_csv": write_csv(d / "missing.csv", missing_ts=True),
        "dir": d,
    }


@functools.lru_cache(maxsize=None)
def jax_fast(path, cfg_items, batch_size=256):
    return jbatch.run_job_fast(path,
                               config=jbatch.BatchJobConfig(**dict(cfg_items)),
                               batch_size=batch_size)


def key(cfg):
    return tuple(sorted(cfg.items()))


def test_native_available():
    assert native.available()


@pytest.mark.parametrize("cfg", [SMALL, DATED], ids=["alltime", "dated"])
def test_fast_csv_equal_jax(data, cfg):
    want = jax_fast(data["csv"], key(cfg))
    assert len(want) > 50
    got = tbatch.run_job_fast(data["csv"], config=tbatch.BatchJobConfig(**cfg),
                              batch_size=256, device="cpu")
    assert got == want
    # The string path on the same file gives the same blobs.
    assert tbatch.run_job(CSVSource(data["csv"]),
                          config=tbatch.BatchJobConfig(**cfg), batch_size=256,
                          device="cpu", max_points_in_flight=0) == want


@pytest.mark.parametrize("use_native", [True, False])
def test_csv_source_batches_equal_jax(data, use_native):
    got = list(CSVSource(data["csv"], use_native=use_native).batches(400))
    want = list(JaxCSVSource(data["csv"], use_native=use_native).batches(400))
    assert len(got) == len(want) == -(-N // 400)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("case", ["csv", "int_csv", "synthetic", "hmpb",
                                  "shards"])
def test_convert_writes_jax_bytes(data, tmp_path, case):
    """``convert_to_hmpb`` writes the JAX package's file bytes: CSV on
    the native route, a weighted CSV on the string route, a synthetic
    source, an HMPB re-conversion and a sharded directory."""
    spec = {"csv": f"csv:{data['csv']}", "int_csv": f"csv:{data['int_csv']}",
            "synthetic": "synthetic:1200:3"}.get(case)
    shard_rows = None
    if case in ("hmpb", "shards"):
        src = tmp_path / "src.hmpb"
        jhmpb.convert_to_hmpb(f"csv:{data['csv']}", str(src))
        spec = f"hmpb:{src}"
        shard_rows = 400 if case == "shards" else None
    out_t, out_j = tmp_path / "t.hmpb", tmp_path / "j.hmpb"
    st = thmpb.convert_to_hmpb(spec, str(out_t), batch_size=300,
                               shard_rows=shard_rows)
    sj = jhmpb.convert_to_hmpb(spec, str(out_j), batch_size=300,
                               shard_rows=shard_rows)
    assert {k: v for k, v in st.items() if k != "output"} == \
        {k: v for k, v in sj.items() if k != "output"}
    if shard_rows:
        names = sorted(p.name for p in out_j.iterdir())
        assert names == sorted(p.name for p in out_t.iterdir())
        assert len(names) == -(-N // shard_rows)
        pairs = [(out_t / n, out_j / n) for n in names]
    else:
        pairs = [(out_t, out_j)]
    for a, b in pairs:
        assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hmpb_read_across_packages(data, tmp_path, writer):
    path = str(tmp_path / "pts.hmpb")
    convert = jhmpb.convert_to_hmpb if writer == "jax" else \
        thmpb.convert_to_hmpb
    convert(f"csv:{data['csv']}", path)
    want = jax_fast(data["csv"], key(DATED))
    got = tbatch.run_job_fast(thmpb.HMPBSource(path),
                              config=tbatch.BatchJobConfig(**DATED),
                              batch_size=256, device="cpu")
    assert got == want
    jgot = jbatch.run_job_fast(jhmpb.HMPBSource(path),
                               config=jbatch.BatchJobConfig(**DATED),
                               batch_size=256)
    assert jgot == want
    # The string view of an HMPB file routes the same.
    assert tbatch.run_job(thmpb.HMPBSource(path),
                          config=tbatch.BatchJobConfig(**DATED),
                          device="cpu", max_points_in_flight=0) == want


def test_hmpb_dir_source_equal_jax(data, tmp_path):
    d = tmp_path / "parts"
    thmpb.convert_to_hmpb(f"csv:{data['csv']}", str(d), shard_rows=400)
    want = jax_fast(data["csv"], key(SMALL))
    got = tbatch.run_job_fast(thmpb.HMPBDirSource(str(d)),
                              config=tbatch.BatchJobConfig(**SMALL),
                              batch_size=256, device="cpu")
    assert got == want
    from heatmap_tpu_torch.io import open_source

    assert isinstance(open_source(f"hmpb:{d}"), thmpb.HMPBDirSource)
    with pytest.raises(ValueError, match="shard assignment"):
        thmpb.HMPBDirSource(str(d), shard_index=2, shard_count=2)


@pytest.mark.parametrize("weights", ["int_csv", "frac_csv"])
def test_weighted_hmpb_equal_jax(data, tmp_path, weights):
    path = str(tmp_path / "w.hmpb")
    thmpb.convert_to_hmpb(f"csv:{data[weights]}", path)
    assert thmpb.HMPBSource(path).has_value
    cfg = dict(SMALL, weighted=True)
    got = tbatch.run_job_fast(thmpb.HMPBSource(path),
                              config=tbatch.BatchJobConfig(**cfg),
                              batch_size=256, device="cpu")
    want = jbatch.run_job_fast(jhmpb.HMPBSource(path),
                               config=jbatch.BatchJobConfig(**cfg),
                               batch_size=256)
    assert got.keys() == want.keys() and len(want) > 50
    if weights == "int_csv":
        assert got == want
    else:
        for k in want:
            g, w = json.loads(got[k]), json.loads(want[k])
            assert g.keys() == w.keys()
            np.testing.assert_allclose(list(g.values()), list(w.values()),
                                       rtol=1e-12)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("kind", ["csv", "hmpb"])
def test_fast_bounded_equal_jax(data, tmp_path, kind, overlap):
    if kind == "csv":
        src = data["csv"]
    else:
        src = thmpb.HMPBSource(
            thmpb.convert_to_hmpb(f"csv:{data['csv']}",
                                  str(tmp_path / "p.hmpb"))["output"])
    got = tbatch.run_job_fast(src, config=tbatch.BatchJobConfig(**DATED),
                              batch_size=256, max_points_in_flight=500,
                              overlap_ingest=overlap, device="cpu")
    assert got == jax_fast(data["csv"], key(DATED))


def test_fast_dated_missing_timestamps_raise(data):
    with pytest.raises(ValueError, match="timestamp"):
        tbatch.run_job_fast(data["missing_csv"],
                            config=tbatch.BatchJobConfig(**DATED),
                            device="cpu")
    # alltime ignores them, as the JAX package does.
    want = jax_fast(data["missing_csv"], key(SMALL))
    assert tbatch.run_job_fast(data["missing_csv"],
                               config=tbatch.BatchJobConfig(**SMALL),
                               batch_size=256, device="cpu") == want


def _resumable(kind, path, ckpt, cfg, injector=None, port=True):
    pkg = tbatch if port else jbatch
    config = pkg.BatchJobConfig(**cfg)
    kw = {"batch_size": 200, "checkpoint_every": 2,
          "fault_injector": injector}
    if port:
        kw["device"] = "cpu"
    if kind == "string":
        src = (CSVSource if port else JaxCSVSource)(path)
        return pkg.run_job_resumable(src, str(ckpt), config=config, **kw)
    if kind == "hmpb":
        path = (thmpb if port else jhmpb).HMPBSource(path)
    return pkg.run_job_fast(path, config=config, checkpoint_dir=str(ckpt),
                            **kw)


@pytest.mark.parametrize("kind", ["fast", "hmpb", "string"])
def test_fault_then_resume(data, tmp_path, kind):
    path = data["csv"]
    if kind == "hmpb":
        path = thmpb.convert_to_hmpb(f"csv:{path}",
                                     str(tmp_path / "p.hmpb"))["output"]
    ckpt = tmp_path / "ckpt"
    inj = FaultInjector({5: 1})
    with pytest.raises(RuntimeError, match="injected fault"):
        _resumable(kind, path, ckpt, DATED, inj)
    assert inj.injected == 1
    assert sorted(p.name for p in ckpt.iterdir()) == ["ckpt-2.npz",
                                                      "ckpt-4.npz"]
    got = _resumable(kind, path, ckpt, DATED)
    assert got == jax_fast(data["csv"], key(DATED))


@pytest.mark.parametrize("writer,kind", [
    pytest.param("jax", "fast", id="fast"),
    pytest.param("jax", "string", id="string"),
    pytest.param("jax", "weighted_string", id="weighted_string"),
    pytest.param("port", "fast", id="to_jax-fast"),
    pytest.param("port", "string", id="to_jax-string"),
    pytest.param("port", "weighted_string", id="to_jax-weighted_string"),
])
def test_resume_from_jax_checkpoint(data, tmp_path, writer, kind):
    """A checkpoint one package wrote before its injected failure
    resumes in the other to the uninterrupted blobs: the JAX package's
    in the port, and the port's in the JAX package."""
    weighted = kind == "weighted_string"
    path = data["int_csv"] if weighted else data["csv"]
    cfg = dict(DATED, weighted=True) if weighted else DATED
    kind = "string" if weighted else kind
    injector = (JaxFaultInjector if writer == "jax" else FaultInjector)(
        {3: 1})
    ckpt = tmp_path / "ckpt"
    with pytest.raises(RuntimeError, match="injected fault"):
        _resumable(kind, path, ckpt, cfg, injector, port=writer == "port")
    got = _resumable(kind, path, ckpt, cfg, port=writer == "jax")
    if weighted:
        want = jbatch.run_job(JaxCSVSource(path),
                              config=jbatch.BatchJobConfig(**cfg),
                              batch_size=200, max_points_in_flight=0)
    else:
        want = jax_fast(path, key(DATED))
    assert got == want


def test_resume_weighted_string_path(data, tmp_path):
    cfg = dict(SMALL, weighted=True)
    ckpt = tmp_path / "ckpt"
    with pytest.raises(RuntimeError, match="injected fault"):
        _resumable("string", data["int_csv"], ckpt, cfg, FaultInjector({3: 1}))
    got = _resumable("string", data["int_csv"], ckpt, cfg)
    want = jbatch.run_job(JaxCSVSource(data["int_csv"]),
                          config=jbatch.BatchJobConfig(**cfg), batch_size=200,
                          max_points_in_flight=0)
    assert got == want


@pytest.mark.parametrize("case", [
    "fast_ckpt_to_string", "string_ckpt_to_fast", "weighted_mismatch",
    "checkpoint_every", "bounded_and_checkpoint", "bounded_and_injector",
    "spill_single_shot", "not_a_fast_source", "fast_weights_missing",
])
def test_refusals(data, tmp_path, case):
    ckpt = tmp_path / "ckpt"
    cfg = tbatch.BatchJobConfig(**SMALL)
    if case in ("fast_ckpt_to_string", "string_ckpt_to_fast",
                "weighted_mismatch"):
        first = "fast" if case == "fast_ckpt_to_string" else "string"
        _resumable(first, data["csv"], ckpt, SMALL)
        second = {"fast_ckpt_to_string": "string",
                  "string_ckpt_to_fast": "fast"}.get(case, first)
        cfg2 = dict(SMALL, weighted=True) if case == "weighted_mismatch" \
            else SMALL
        match = "counted job" if case == "weighted_mismatch" else "job path"
        with pytest.raises(RuntimeError, match=match):
            _resumable(second, data["csv"], ckpt, cfg2)
        return
    with pytest.raises((ValueError, TypeError)) as err:
        if case == "checkpoint_every":
            tbatch.run_job_resumable(CSVSource(data["csv"]), str(ckpt),
                                     config=cfg, checkpoint_every=0,
                                     device="cpu")
        elif case == "bounded_and_checkpoint":
            tbatch.run_job_fast(data["csv"], config=cfg,
                                max_points_in_flight=100,
                                checkpoint_dir=str(ckpt), device="cpu")
        elif case == "bounded_and_injector":
            tbatch.run_job_fast(data["csv"], config=cfg,
                                max_points_in_flight=100,
                                fault_injector=FaultInjector({}),
                                device="cpu")
        elif case == "spill_single_shot":
            tbatch.run_job_fast(data["csv"], config=cfg,
                                max_points_in_flight=0,
                                merge_spill_dir=str(tmp_path), device="cpu")
        elif case == "not_a_fast_source":
            tbatch.run_job_fast(SyntheticSource(n=10), config=cfg,
                                device="cpu")
        else:
            tbatch.run_job_fast(data["csv"],
                                config=tbatch.BatchJobConfig(weighted=True),
                                device="cpu")
    want = {"checkpoint_every": ">= 1", "bounded_and_checkpoint":
            "mutually exclusive", "bounded_and_injector": "fault_injector",
            "spill_single_shot": "bounded path",
            "not_a_fast_source": "fast-batch source",
            "fast_weights_missing": "'value' column"}[case]
    assert want in str(err.value)


@pytest.mark.parametrize("damage", ["magic", "truncated", "header"])
def test_hmpb_reader_rejects_damaged_files(data, tmp_path, damage):
    path = tmp_path / "p.hmpb"
    thmpb.convert_to_hmpb(f"csv:{data['csv']}", str(path))
    raw = path.read_bytes()
    if damage == "magic":
        raw = b"NOPE" + raw[4:]
    elif damage == "truncated":
        raw = raw[: len(raw) // 2]
    else:
        raw = raw[:15] + b"{" + raw[16:]  # "{{" opens the JSON
    path.write_bytes(raw)
    with pytest.raises(ValueError, match="HMPB|truncated"):
        thmpb.HMPBSource(str(path))
    with pytest.raises(ValueError, match="HMPB|truncated"):
        jhmpb.HMPBSource(str(path))
