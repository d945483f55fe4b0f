"""The port's Morton-range planner (heatmap_tpu_torch.parallel.partition)
against heatmap_tpu.parallel.partition on the CPU: the same seeded codes
give the same plans (splits, masses, re-splits, fingerprint), the same
weighted-median re-splits and the same routed segments, and each plan
keeps the JAX tests' properties (determinism, balance, degenerate plans,
boundary tiles against brute force, the partition_planned event). The
run_job Morton-DP cases wait for the rest of parallel/ (ROADMAP Queue 1
item 7)."""

import dataclasses

import numpy as np
import pytest

from heatmap_tpu import obs as jobs
from heatmap_tpu.parallel import partition as jpart
from heatmap_tpu_torch import obs as tobs
from heatmap_tpu_torch.parallel import partition as tpart
from heatmap_tpu_torch.tilemath import split_boundary_codes_np

DZ = 12
SPACE = 1 << (2 * DZ)


def _same_plan(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.skew_ratio == j.skew_ratio and t.degenerate == j.degenerate


def _cases():
    rng = np.random.default_rng(3)
    hot = np.concatenate([np.full(10_000, 123_456, np.int64),
                          np.random.default_rng(7).choice(
                              SPACE, size=40_000, replace=False)])
    return {
        "uniform": (rng.integers(0, SPACE, 50_000), 8, {"seed": 5}),
        "distinct": (np.random.default_rng(11).choice(
            SPACE, size=40_000, replace=False), 8, {}),
        "hotspot": (hot, 8, {"seed": 1}),
        "sampled": (rng.integers(0, SPACE, 100_000), 4,
                    {"sample_size": 4096, "seed": 2}),
        "tight": (hot, 5, {"balance_factor": 1.05, "max_resplits": 3}),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_plans_equal_jax(name):
    codes, n, kw = _cases()[name]
    _same_plan(tpart.plan_partition(codes, n, detail_zoom=DZ, **kw),
               jpart.plan_partition(codes, n, detail_zoom=DZ, **kw))


def test_plan_determinism_and_monotonicity():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, SPACE, 50_000)
    a = tpart.plan_partition(codes, 8, detail_zoom=DZ, seed=5)
    b = tpart.plan_partition(codes, 8, detail_zoom=DZ, seed=5)
    assert a.splits == b.splits and a.fingerprint == b.fingerprint
    assert len(a.splits) == 7 and a.n_shards == 8
    assert list(a.splits) == sorted(a.splits)
    c = tpart.plan_partition(codes, 8, detail_zoom=DZ, seed=6)
    assert list(c.splits) == sorted(c.splits)
    # Ownership convention: a split opens the range to its right.
    s0 = a.splits[0]
    assert a.shard_of_codes(np.asarray([s0 - 1, s0, s0 + 1])).tolist() \
        == [0, 1, 1]


def test_plan_quantiles_balance_distinct_codes():
    codes = np.random.default_rng(11).choice(SPACE, size=40_000,
                                             replace=False)
    plan = tpart.plan_partition(codes, 8, detail_zoom=DZ)
    assert plan.resplits == 0
    assert plan.skew_ratio <= 1.25
    assert not plan.degenerate


def test_resplit_bounds_pathological_hotspot_skew():
    codes, n, kw = _cases()["hotspot"]
    plan = tpart.plan_partition(codes, n, detail_zoom=DZ, **kw)
    assert plan.resplits >= 1
    assert plan.skew_ratio <= 2.0, plan.shard_mass
    assert not plan.degenerate


@pytest.mark.parametrize("codes,n,valid", [
    (np.asarray([], np.int64), 4, None),
    (np.arange(100), 1, None),
    (np.full(5_000, 42, np.int64), 4, None),
    (np.arange(100), 4, np.zeros(100, bool)),
])
def test_degenerate_plans(codes, n, valid):
    t = tpart.plan_partition(codes, n, detail_zoom=DZ, valid=valid)
    assert t.degenerate
    _same_plan(t, jpart.plan_partition(codes, n, detail_zoom=DZ,
                                       valid=valid))


def test_n_shards_refusal_matches_jax():
    with pytest.raises(ValueError) as je:
        jpart.plan_partition(np.arange(4), 0, detail_zoom=DZ)
    with pytest.raises(ValueError) as te:
        tpart.plan_partition(np.arange(4), 0, detail_zoom=DZ)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("trial", range(5))
def test_boundary_codes_match_brute_force(trial):
    rng = np.random.default_rng(19 + trial)
    splits = np.sort(rng.integers(1, SPACE, 7))
    fields = dict(detail_zoom=DZ, n_shards=8,
                  splits=tuple(int(s) for s in splits), sampled_points=1,
                  balance_factor=1.25, shard_mass=(1.0,) * 8, resplits=0,
                  fingerprint="t")
    plan, jplan = tpart.PartitionPlan(**fields), jpart.PartitionPlan(**fields)
    assert split_boundary_codes_np(splits, 0).size == 0
    for lvl in range(1, 7):
        got = set(plan.boundary_codes(lvl).tolist())
        assert got == set(jplan.boundary_codes(lvl).tolist())
        cand = np.unique(splits >> np.int64(2 * lvl))
        lo = cand << np.int64(2 * lvl)
        hi = lo + (np.int64(1) << np.int64(2 * lvl)) - 1
        first = plan.shard_of_codes(lo)
        last = plan.shard_of_codes(hi)
        assert got == set(cand[first != last].tolist()), (trial, lvl)
    assert plan.boundary_tiles_total(6) == jplan.boundary_tiles_total(6) \
        == sum(len(plan.boundary_codes(v)) for v in range(1, 7))
    assert all(len(plan.boundary_codes(v)) <= 7 for v in range(1, 7))
    assert plan.code_ranges() == jplan.code_ranges()


@pytest.mark.parametrize("bucket", [None, "pow2"])
def test_route_emissions_round_trip(bucket):
    rng = np.random.default_rng(23)
    n = 4_096
    codes = rng.integers(0, SPACE, n)
    slots = rng.integers(0, 5, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    w = rng.integers(1, 9, n).astype(np.float64)
    plan = tpart.plan_partition(codes, 8, detail_zoom=DZ)
    jplan = jpart.plan_partition(codes, 8, detail_zoom=DZ)
    fn = None if bucket is None else (
        lambda x: 1 << int(np.ceil(np.log2(max(x, 1)))))
    got = tpart.route_emissions(plan, codes, slots, valid=valid, weights=w,
                                bucket=fn)
    want = jpart.route_emissions(jplan, codes, slots, valid=valid,
                                 weights=w, bucket=fn)
    for g, x in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, x)
    rc, rs, rv, rw, seg = got
    assert seg == want[4] and rc.shape == (8 * seg,)
    assert sorted(zip(rc[rv], rs[rv], rw[rv])) == sorted(
        zip(codes[valid], slots[valid], w[valid]))
    sid = plan.shard_of_codes(rc[rv])
    assert np.array_equal(sid, np.flatnonzero(rv) // seg)
    if bucket:
        assert seg & (seg - 1) == 0


def test_route_emissions_empty_ranges():
    fields = dict(detail_zoom=DZ, n_shards=4, splits=(100, 100, 100),
                  sampled_points=1, balance_factor=1.25,
                  shard_mass=(0.5, 0.0, 0.0, 0.5), resplits=0,
                  fingerprint="t")
    codes = np.asarray([5, 50, 99, 100, 101, SPACE - 1], np.int64)
    slots = np.zeros(6, np.int32)
    rc, rs, rv, _, seg = tpart.route_emissions(
        tpart.PartitionPlan(**fields), codes, slots)
    want = jpart.route_emissions(jpart.PartitionPlan(**fields), codes, slots)
    np.testing.assert_array_equal(rc, want[0])
    np.testing.assert_array_equal(rv, want[2])
    assert sorted(rc[rv].tolist()) == sorted(codes.tolist())
    assert not rv[1 * seg:3 * seg].any()


@pytest.mark.parametrize("seed", range(6))
def test_split_range_median_matches_jax(seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << 20, 3000)
    weights = rng.integers(-3, 9, 3000).astype(np.float64)
    if seed == 4:
        codes[:2000] = 777  # a hot code holding most of the mass
    lo, hi = sorted(int(v) for v in rng.integers(0, 1 << 20, 2))
    cases = [(lo, hi), (0, 1 << 20), (777, 778), (777, 1 << 20), (5, 5)]
    for a, b in cases:
        got = tpart.split_range_median(codes, weights, a, b)
        assert got == jpart.split_range_median(codes, weights, a, b)
        if got is not None:
            assert a < got < b


def test_split_range_median_irreducible_and_empty():
    assert tpart.split_range_median([], [], 0, 10) is None
    assert tpart.split_range_median([3, 3, 3], [1, 2, 3], 3, 10) is None
    assert tpart.split_range_median([3, 4], [0, 0], 0, 10) is None


def test_partition_planned_event_and_metrics(tmp_path):
    """Both packages emit the same partition_planned record and set the
    same gauge and counter."""
    codes = np.random.default_rng(31).choice(SPACE, size=20_000,
                                             replace=False)
    recs = {}
    for name, obs, part in (("torch", tobs, tpart), ("jax", jobs, jpart)):
        path = str(tmp_path / f"{name}.jsonl")
        obs.get_registry().reset()
        obs.enable_metrics(True)
        obs.set_event_log(obs.EventLog(path))
        try:
            plan = part.plan_partition(codes, 8, detail_zoom=DZ, n_levels=6)
            assert obs.PARTITION_SKEW.value() == pytest.approx(
                plan.skew_ratio)
            assert obs.BOUNDARY_TILES.value() == plan.boundary_tiles_total(6)
        finally:
            log = obs.get_event_log()
            obs.set_event_log(None)
            log.close()
            obs.enable_metrics(False)
            obs.get_registry().reset()
        [rec] = obs.read_events(path)
        recs[name] = {k: v for k, v in rec.items()
                      if k not in ("ts", "run_id", "seq", "pid", "host")}
    assert recs["torch"] == recs["jax"]
    rec = recs["torch"]
    assert rec["event"] == "partition_planned"
    assert rec["n_shards"] == 8 and len(rec["splits"]) == 7
    assert not rec["degenerate"]
