"""The port's brownout ladder (heatmap_tpu_torch.serve.degrade) against
the JAX package's: the same rungs for the same scripted burn schedule
and fake clock, the same edge events, the same ladder-spec errors, the
same shed keys and Retry-After jitter. The rung policies on the serve
path are held to the JAX answers in test_torch_serve.py."""

import json

import pytest

from heatmap_tpu import faults as jfaults
from heatmap_tpu import obs as jobs
from heatmap_tpu.serve import degrade as jdegrade
from heatmap_tpu_torch import faults as tfaults
from heatmap_tpu_torch import obs as tobs
from heatmap_tpu_torch.serve import degrade as tdegrade

SCHEDULES = {
    "climb_and_recover": ([2.0] * 40 + [0.1] * 120, 1.0),
    "dead_band": ([2.0] * 12 + [0.75] * 60 + [2.0] * 15, 1.0),
    "oscillate": ([1.0 if t % 2 == 0 else 1.3 for t in range(26)], 1.0),
    "flap_across": ([1.5 if t % 2 == 0 else 0.75 for t in range(60)], 1.0),
    "half_second": ([3.0] * 30 + [0.0] * 30, 0.5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("kw", [{}, {"dwell_s": 1.0, "hold_s": 3.0},
                                {"max_rung": 2, "up_threshold": 1.2,
                                 "down_threshold": 0.3}])
def test_ladder_matches_jax(name, kw, tmp_path):
    burns, step = SCHEDULES[name]
    rungs, events = {}, {}
    for pkg, mod, obs in (("jax", jdegrade, jobs), ("torch", tdegrade, tobs)):
        path = str(tmp_path / f"{pkg}.jsonl")
        log = obs.EventLog(path, run_id="ladder")
        obs.set_event_log(log)
        try:
            c = mod.BrownoutController(**{"dwell_s": 10.0, "hold_s": 10.0,
                                          **kw})
            rungs[pkg] = [c.observe({"s": b}, t * step)
                          for t, b in enumerate(burns)]
            rungs[pkg].append(json.dumps(c.snapshot(), sort_keys=True))
        finally:
            obs.set_event_log(None)
            log.close()
        events[pkg] = [{k: v for k, v in r.items()
                        if k not in ("ts", "seq", "pid", "host")}
                       for r in obs.read_events(path)
                       if r["event"] == "degrade_step"]
    assert rungs["torch"] == rungs["jax"]
    assert events["torch"] == events["jax"]
    if name == "climb_and_recover":
        assert len(events["torch"]) >= 2


@pytest.mark.parametrize("spec", [
    "", "up=2,down=0.25,ttl=8,shed=1,max=2", "uq=2", "up=fast",
    "shed=1.5", "max=0", "up=1,down=1", "ttl=0.5"])
def test_ladder_spec_matches_jax(spec):
    def run(mod):
        try:
            c = mod.controller_from_flags(True, 2.0, 3.0, spec)
            return ("ok", json.dumps(c.snapshot(), sort_keys=True),
                    mod.parse_ladder_spec(spec))
        except ValueError as e:
            return ("error", str(e))

    assert run(tdegrade) == run(jdegrade)
    assert tdegrade.controller_from_flags(False, 1.0, 1.0, spec) is None


@pytest.mark.parametrize("seed", [None, 99])
def test_shed_keys_and_jitter_match_jax(seed):
    keys = [("default", str(z), str(x), str(y), fmt)
            for z in (3, 4) for x in range(8) for y in range(8)
            for fmt in ("png", "json")]
    if seed is not None:
        jfaults.install(jfaults.FaultPlane(seed=seed))
        tfaults.install(tfaults.FaultPlane(seed=seed))
    try:
        for frac in (0.0, 0.3, 0.5, 1.0):
            assert ([tdegrade.shed_tile(frac, k) for k in keys]
                    == [jdegrade.shed_tile(frac, k) for k in keys])
        for path in ("/tiles/default/3/1/2.png", "/healthz", "/x"):
            for bucket in range(5):
                assert (tdegrade.retry_after_jitter(1.0, path, bucket)
                        == jdegrade.retry_after_jitter(1.0, path, bucket))
    finally:
        jfaults.install(None)
        tfaults.install(None)


def test_policy_helpers_match_jax():
    for rung in range(4):
        got, want = [], []
        for mod, out in ((tdegrade, got), (jdegrade, want)):
            c = mod.BrownoutController(burn_source=lambda: {"p": 0.75},
                                       poll_interval_s=0.0,
                                       shed_fraction=0.5, ttl_stretch=6.0)
            c.rung = rung
            out += [c.force_synopsis(), c.stretch_synopsis(),
                    c.ttl_scale(), c.inflight_limit(None),
                    c.inflight_limit(9), c.poll(5.0),
                    c.shed(("default", "3", "1", "1", "png"))]
        assert got == want, rung
