"""The chunked (bounded) batch job on the CPU: the port's ``run_job`` with
``max_points_in_flight`` against heatmap_tpu's ``run_job`` on the same
seeded sources, blob dicts byte-identical (fractional weighted sums
within ``rtol=1e-12``, the f64 summation-order bound the JAX package
states), under several chunk sizes, with and without the overlapped
feeder, with an explicit spill dir, with automatic spill, with
``amplify_all``, weights and several timespans; the automatic routing
and its host-state probes; and ``arrays:`` output against the JAX
``LevelArraysSink``'s files."""

import functools
import glob
import json

import numpy as np
import pytest

from heatmap_tpu.io.sinks import LevelArraysSink as JaxLevelArraysSink
from heatmap_tpu.io.sources import SyntheticSource as JaxSyntheticSource
from heatmap_tpu.pipeline import batch as jbatch
from heatmap_tpu_torch.io import LevelArraysSink, SyntheticSource, open_sink
from heatmap_tpu_torch.pipeline import batch as tbatch
from heatmap_tpu_torch.pipeline.feeder import FeederStats

N = 2400
SEED = 7
BATCH = 256
SMALL = {"detail_zoom": 12, "min_detail_zoom": 6,
         "timespans": ("alltime", "month")}


class Valued:
    """A synthetic stream plus a ``value`` column made from the seed:
    integers in [0, 100], or fractions in [0, 10)."""

    def __init__(self, inner, fractional=False):
        self.inner = inner
        self.fractional = fractional

    def batches(self, batch_size):
        for i, b in enumerate(self.inner.batches(batch_size)):
            rng = np.random.default_rng([SEED, i])
            n = len(b["latitude"])
            b["value"] = (rng.random(n) * 10 if self.fractional
                          else rng.integers(0, 101, n).astype(np.float64))
            yield b


def sources(n=N, seed=SEED, weights=None):
    """(port source, JAX source) over the same point stream."""
    t, j = SyntheticSource(n=n, seed=seed), JaxSyntheticSource(n=n, seed=seed)
    if weights is not None:
        t, j = Valued(t, weights == "fractional"), Valued(j, weights ==
                                                          "fractional")
    return t, j


@functools.lru_cache(maxsize=None)
def jax_reference(cfg_items, weights=None):
    """heatmap_tpu's single-shot blobs (computed once per config)."""
    _, j = sources(weights=weights)
    return jbatch.run_job(j, config=jbatch.BatchJobConfig(**dict(cfg_items)),
                          batch_size=BATCH, max_points_in_flight=0)


def port_bounded(cfg, weights=None, **kw):
    t, _ = sources(weights=weights)
    kw.setdefault("batch_size", BATCH)
    return tbatch.run_job(t, config=tbatch.BatchJobConfig(**cfg),
                          device="cpu", **kw)


def ref(cfg, weights=None):
    return jax_reference(tuple(sorted(cfg.items())), weights)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("max_points", [300, 700, 1500, 10_000])
def test_bounded_equal_jax(max_points, overlap):
    stats = FeederStats()
    got = port_bounded(SMALL, max_points_in_flight=max_points,
                       overlap_ingest=overlap, feeder_stats=stats)
    assert len(got) > 100
    assert got == ref(SMALL)
    if overlap:
        # One chunk when the source fits it, several otherwise.
        assert stats.batches == 1 if max_points >= N else stats.batches > 1
        assert stats.depth_hwm == 1
    else:
        assert stats.batches == 0


def test_bounded_equal_jax_bounded_same_arguments():
    """Against the JAX package's own chunked path, same arguments."""
    _, j = sources()
    want = jbatch.run_job(j, config=jbatch.BatchJobConfig(**SMALL),
                          batch_size=BATCH, max_points_in_flight=700)
    assert port_bounded(SMALL, max_points_in_flight=700) == want


@pytest.mark.parametrize("amplify", [False, True])
def test_explicit_spill_equal_jax(tmp_path, amplify):
    cfg = dict(SMALL, amplify_all=amplify)
    root = tmp_path / "spill"
    got = port_bounded(cfg, max_points_in_flight=700,
                       merge_spill_dir=str(root))
    assert got == ref(cfg)
    assert list(root.iterdir()) == []  # the run directory is removed


def test_amplify_all_bounded_equal_jax():
    cfg = dict(SMALL, amplify_all=True)
    assert port_bounded(cfg, max_points_in_flight=700) == ref(cfg)


def test_auto_spill_converts_once_and_matches(monkeypatch, tmp_path):
    created = []
    real = tbatch._SpillMerge

    class Spy(real):
        def __init__(self, root, n_levels):
            super().__init__(root, n_levels)
            created.append(self.dir)

    monkeypatch.setattr(tbatch, "_SpillMerge", Spy)
    monkeypatch.setattr(tbatch, "AUTO_SPILL_ROWS", 500)
    monkeypatch.setattr(tbatch, "AUTO_SPILL_DIR", str(tmp_path))
    monkeypatch.setattr(tbatch, "_auto_spill_target",
                        lambda: tbatch.AUTO_SPILL_DIR)
    got = port_bounded(SMALL, max_points_in_flight=700)
    assert got == ref(SMALL)
    assert len(created) == 1
    assert not glob.glob(created[0] + "*")


def test_auto_spill_write_failure_folds_back(monkeypatch, tmp_path):
    """An automatic spill whose later write fails folds its runs back
    into RAM with a warning, and the blobs do not change."""
    monkeypatch.setattr(tbatch, "AUTO_SPILL_ROWS", 500)
    monkeypatch.setattr(tbatch, "_auto_spill_target", lambda: str(tmp_path))
    real_add = tbatch._SpillMerge.add_level
    calls = {"n": 0}

    def flaky(self, run, level, *cols):
        calls["n"] += 1
        if run >= 1 and level == 3:
            raise OSError(28, "No space left on device")
        return real_add(self, run, level, *cols)

    monkeypatch.setattr(tbatch._SpillMerge, "add_level", flaky)
    with pytest.warns(RuntimeWarning, match="auto-spill write failed"):
        got = port_bounded(SMALL, max_points_in_flight=700)
    assert got == ref(SMALL)
    assert calls["n"] > 0
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("timespans", [("year", "day"), ("month",)])
def test_timespans_bounded_equal_jax(timespans):
    cfg = dict(SMALL, timespans=timespans)
    assert port_bounded(cfg, max_points_in_flight=700) == ref(cfg)


def test_integer_weights_bounded_byte_equal():
    cfg = dict(SMALL, weighted=True)
    want = ref(cfg, "integer")
    assert port_bounded(cfg, "integer", max_points_in_flight=700) == want
    # And against the JAX package's chunked path.
    _, j = sources(weights="integer")
    assert want == jbatch.run_job(j, config=jbatch.BatchJobConfig(**cfg),
                                  batch_size=BATCH, max_points_in_flight=700)


def test_fractional_weights_bounded_within_rtol():
    cfg = dict(SMALL, weighted=True)
    want = ref(cfg, "fractional")
    got = port_bounded(cfg, "fractional", max_points_in_flight=700)
    assert got.keys() == want.keys()
    for k in want:
        g, w = json.loads(got[k]), json.loads(want[k])
        assert g.keys() == w.keys()
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   rtol=1e-12)


def test_weighted_bounded_missing_value_column_raises():
    with pytest.raises(ValueError, match="'value' column"):
        port_bounded(dict(SMALL, weighted=True), max_points_in_flight=700)


def test_bounded_equals_port_single_shot():
    single = tbatch.run_job(SyntheticSource(n=N, seed=SEED),
                            config=tbatch.BatchJobConfig(**SMALL),
                            device="cpu", max_points_in_flight=0)
    assert port_bounded(SMALL, max_points_in_flight=500) == single


def test_auto_routing_takes_bounded_path(monkeypatch):
    """With host RAM faked tiny, the default call chunks on its own and
    stays equal; 0 forces single-shot."""
    taken = {}
    real = tbatch._run_job_bounded

    def spy(source, sink, config, batch_size, max_points, **kw):
        taken["max_points"] = max_points
        return real(source, sink, config, batch_size, max_points, **kw)

    monkeypatch.setattr(tbatch, "_run_job_bounded", spy)
    monkeypatch.setattr(tbatch, "_available_ram_bytes", lambda: 96 << 10)
    got = port_bounded(SMALL)
    assert taken["max_points"] == 1 << 16
    assert got == ref(SMALL)
    taken.clear()
    port_bounded(SMALL, max_points_in_flight=0)
    assert not taken


@pytest.mark.parametrize("case", [
    dict(n=1000, ram_budget=1 << 30),
    dict(n=50_000_000, ram_budget=1 << 30),
    dict(n=50_000_000, ram_budget=75 << 20),
    dict(n=50_000_000, ram_budget=1 << 30, shard_count=4),
    dict(n=2_000_000, ram_budget=1 << 30, fast=True, hmpb=True),
    dict(n=2_000_000, ram_budget=1 << 30, fast=True, hmpb=True,
         n_timespans=3, weighted=True),
])
def test_auto_points_in_flight_equal_jax(case):
    case = dict(case)
    n = case.pop("n")

    class Declared:
        pass

    src = Declared()
    src.n = n
    if case.pop("hmpb", False):
        src.fast_host_bytes_per_point = 30
    assert (tbatch._auto_points_in_flight(src, **case)
            == jbatch._auto_points_in_flight(src, **case))
    assert tbatch._auto_points_in_flight(object()) is None


def test_estimate_points_and_host_probes(tmp_path, monkeypatch):
    p = tmp_path / "pts.csv"
    p.write_text("lat,lon,user\n" * 1000)
    assert (tbatch._estimate_source_points(str(p))
            == jbatch._estimate_source_points(str(p))
            == p.stat().st_size // tbatch._MIN_TEXT_ROW_BYTES)
    assert tbatch._estimate_source_points(SyntheticSource(n=123)) == 123
    mounts = tmp_path / "mounts"
    mounts.write_text("/dev/root / ext4 rw 0 0\n"
                      "tmpfs /ramtmp tmpfs rw 0 0\n"
                      "/dev/sdb /ramtmp/disk ext4 rw 0 0\n")
    for path, want in [("/ramtmp/x", "tmpfs"), ("/ramtmp/disk/x", "ext4"),
                       ("/var/spool", "ext4")]:
        assert tbatch._mount_fstype(path, str(mounts)) == want
        assert jbatch._mount_fstype(path, str(mounts)) == want
    real = tbatch._mount_fstype
    monkeypatch.setattr(tbatch, "_mount_fstype",
                        lambda path: real(path, str(mounts)))
    monkeypatch.setattr(tbatch, "AUTO_SPILL_DIR", "/ramtmp/x")
    assert tbatch._auto_spill_target() is None
    monkeypatch.setattr(tbatch, "AUTO_SPILL_DIR", "/var/spool")
    assert tbatch._auto_spill_target() == "/var/spool"
    for args in [(str(tmp_path), 10, 1, 4, 10), ("/nonexistent", 10, 1, None,
                                                 10),
                 (str(tmp_path), 1 << 60, 1, 4, 1)]:
        assert (tbatch._auto_spill_projection_fits(*args)
                == jbatch._auto_spill_projection_fits(*args))


def test_level_key_packer_widens_int32():
    """ts/g arrive int32 off the native decoder; << code_bits must not
    wrap."""
    ts = np.array([0, 1, 1], np.int32)
    g = np.array([3, 0, 2], np.int32)
    code = np.array([(1 << 41) + 5, 7, 1 << 40], np.int64)
    pack = tbatch._level_key_packer(ts, g, code)
    got = pack(ts, g, code)
    want = ((ts.astype(np.int64) * 4 + g) << 42) | code
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got) > 0).all()


def test_spill_requires_bounded_path_and_cleans_up(tmp_path):
    with pytest.raises(ValueError, match="bounded path"):
        tbatch.run_job(SyntheticSource(n=50), config=tbatch.BatchJobConfig(),
                       device="cpu", max_points_in_flight=0,
                       merge_spill_dir=str(tmp_path))

    class Boom:
        def batches(self, batch_size):
            yield from SyntheticSource(n=600, seed=3).batches(batch_size)
            raise RuntimeError("source died")

    root = tmp_path / "spill"
    with pytest.raises(RuntimeError, match="source died"):
        tbatch.run_job(Boom(), config=tbatch.BatchJobConfig(**SMALL),
                       batch_size=100, max_points_in_flight=200,
                       merge_spill_dir=str(root), device="cpu")
    assert list(root.iterdir()) == []
    with pytest.raises(ValueError, match=">= 1"):
        tbatch._run_job_bounded(SyntheticSource(n=5), None,
                                tbatch.BatchJobConfig(), 8, 0, device="cpu")


def test_empty_source_bounded():
    assert tbatch.run_job(SyntheticSource(n=0), device="cpu",
                          max_points_in_flight=10) == {}


@pytest.mark.parametrize("spill", [False, True])
def test_arrays_sink_equal_jax(tmp_path, spill):
    """The ``arrays:`` files of a chunked job hold the arrays (values and
    dtypes) of the JAX package's ``LevelArraysSink`` files."""
    cfg = dict(SMALL, weighted=True)
    t, j = sources(weights="integer")
    kw = {"batch_size": BATCH, "max_points_in_flight": 700}
    jspill = {"merge_spill_dir": str(tmp_path / "js")} if spill else {}
    tspill = {"merge_spill_dir": str(tmp_path / "ts")} if spill else {}
    want = jbatch.run_job(j, JaxLevelArraysSink(str(tmp_path / "jax")),
                          config=jbatch.BatchJobConfig(**cfg), **kw, **jspill)
    with open_sink(f"arrays:{tmp_path / 'port'}") as sink:
        got = tbatch.run_job(t, sink, config=tbatch.BatchJobConfig(**cfg),
                             device="cpu", **kw, **tspill)
    assert got == want and got["egress"] == "levels" and got["rows"] > 0
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 6
    for name in names:
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            assert a.files == b.files
            for k in b.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k])
    loaded = LevelArraysSink.load(str(tmp_path / "port"))
    jloaded = JaxLevelArraysSink.load(str(tmp_path / "jax"))
    assert loaded.keys() == jloaded.keys()
    for z in jloaded:
        assert loaded[z].keys() == jloaded[z].keys()
        for k in jloaded[z]:
            np.testing.assert_array_equal(loaded[z][k], jloaded[z][k])


def test_arrays_sink_refuses_blobs_and_unknown_format(tmp_path):
    sink = LevelArraysSink(str(tmp_path))
    with pytest.raises(TypeError, match="columnar-only"):
        sink.write([("a", "{}")])
    with pytest.raises(ValueError, match="format"):
        LevelArraysSink(str(tmp_path), format="feather")
    compressed = LevelArraysSink(str(tmp_path / "c"), format="npz-compressed")
    plain = LevelArraysSink(str(tmp_path / "p"))
    for s in (compressed, plain):
        tbatch.run_job(SyntheticSource(n=500, seed=1), s,
                       tbatch.BatchJobConfig(**SMALL), device="cpu")
    a = LevelArraysSink.load(str(tmp_path / "c"))
    b = LevelArraysSink.load(str(tmp_path / "p"))
    assert a.keys() == b.keys()
    for z in a:
        for k in a[z]:
            np.testing.assert_array_equal(a[z][k], b[z][k])
