"""The port's double-buffered feeder (pipeline/feeder.py) on the CPU:
FIFO order, ``FeederStats``, the depth bound, a worker error re-raised in
the consumer, an injected ``feeder.put`` fault retried, a terminal one
propagated, a consumer exception stopping the worker, and the JAX
package's feeder giving the same items and counts on the same input."""

import threading
import time

import pytest

from heatmap_tpu import faults as jfaults
from heatmap_tpu.pipeline import feeder as jfeeder
from heatmap_tpu_torch import faults
from heatmap_tpu_torch.pipeline import feeder


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_order_stats_and_equal_jax(depth):
    items = list(range(40))
    st = feeder.FeederStats()
    got = list(feeder.feed(iter(items), lambda x: x * 3, depth=depth,
                           stats=st))
    jst = jfeeder.FeederStats()
    want = list(jfeeder.feed(iter(items), lambda x: x * 3, depth=depth,
                             stats=jst))
    assert got == want == [x * 3 for x in items]
    assert st.batches == jst.batches == len(items)
    assert 1 <= st.depth_hwm <= depth
    assert st.feed_s >= 0.0 and st.wait_s >= 0.0
    assert 0.0 <= st.overlap_pct <= 100.0


def test_overlap_pct_contract():
    assert feeder.FeederStats().overlap_pct == 100.0
    assert feeder.FeederStats(feed_s=2.0, wait_s=0.5).overlap_pct == 75.0
    assert feeder.FeederStats(feed_s=1.0, wait_s=3.0).overlap_pct == 0.0
    for kw in [dict(feed_s=2.0, wait_s=0.5), dict(feed_s=1.0, wait_s=3.0)]:
        assert (feeder.FeederStats(**kw).overlap_pct
                == jfeeder.FeederStats(**kw).overlap_pct)


@pytest.mark.parametrize("depth", [1, 3])
def test_depth_bound_holds_producer_back(depth):
    """The worker never runs more than ``depth`` fed items, plus the one
    it is transferring, ahead of the consumer (depth 1: at most 3 items
    alive, the chunked job's memory bound)."""
    lock = threading.Lock()
    produced = {"n": 0}
    consumed = {"n": 0}
    ahead = []

    def source():
        for i in range(30):
            with lock:
                produced["n"] += 1
                ahead.append(produced["n"] - consumed["n"])
            yield i

    for _ in feeder.feed(source(), lambda x: x, depth=depth):
        time.sleep(0.002)  # a slow consumer: the producer runs ahead
        with lock:
            consumed["n"] += 1
    assert max(ahead) <= depth + 2
    assert produced["n"] == consumed["n"] == 30


@pytest.mark.parametrize("where", ["source", "transfer"])
def test_worker_error_reraised(where):
    def source():
        yield 1
        yield 2
        if where == "source":
            raise KeyError("source broke")
        yield 3

    def transfer(x):
        if where == "transfer" and x == 3:
            raise KeyError("transfer broke")
        return x

    got = []
    with pytest.raises(KeyError, match="broke"):
        for x in feeder.feed(source(), transfer):
            got.append(x)
    assert got == [1, 2]


def test_injected_fault_retried_then_terminal_propagates():
    plane = faults.FaultPlane(backoff_scale=0.0)
    plane.add_rule("feeder.put", key=2, count=2)  # within the retry budget
    faults.install(plane)
    try:
        calls = []
        got = list(feeder.feed(range(5), lambda x: calls.append(x) or x))
        assert got == list(range(5))
        assert plane.injected == 2
        assert calls == list(range(5))  # injected before the transfer ran
        terminal = faults.FaultPlane(backoff_scale=0.0)
        terminal.add_rule("feeder.put", key=1, count=10)
        faults.install(terminal)
        with pytest.raises(faults.InjectedFault, match="feeder.put@1"):
            list(feeder.feed(range(5), lambda x: x))
        assert terminal.injected == faults.policy_for("feeder.put").retries + 1
    finally:
        faults.install(None)
    # The JAX package's plane leaves the port's feeder alone.
    jfaults.install(jfaults.parse_spec("scale=0,feeder.put=100"))
    try:
        assert list(feeder.feed(range(3), lambda x: x)) == [0, 1, 2]
    finally:
        jfaults.install(None)


def test_consumer_exception_stops_worker():
    started = threading.Event()

    def source():
        for i in range(1000):
            started.set()
            yield i

    with pytest.raises(ZeroDivisionError):
        # The loop holds the only reference: unwinding closes it.
        for x in feeder.feed(source(), lambda x: x):
            if x == 3:
                1 / 0
    assert started.is_set()
    alive = [t for t in threading.enumerate() if t.name == "feeder"]
    for t in alive:
        t.join(timeout=5.0)
        assert not t.is_alive()


def test_depth_validated_and_cpu_ready_passthrough():
    with pytest.raises(ValueError, match="depth"):
        feeder.feed([], lambda x: x, depth=0)
    item = (1, 2, 3)
    assert feeder.ready(item) is item


def test_retry_policy_and_plane_copies_equal_jax():
    for site in ("feeder.put", "source.read", "sink.write", "shard.compute"):
        assert faults.policy_for(site) == faults.RetryPolicy(
            **jfaults.policy_for(site).__dict__)
    assert faults.SITES == jfaults.SITES
    spec = "seed=7,scale=0,feeder.put=3x2,source.read=p0.5"
    a, b = faults.parse_spec(spec), jfaults.parse_spec(spec)
    fired_a, fired_b = [], []
    for plane, fired, exc in ((a, fired_a, faults.InjectedFault),
                              (b, fired_b, jfaults.InjectedFault)):
        for i in range(20):
            for site in ("feeder.put", "source.read"):
                try:
                    plane.check(site, key=i)
                    fired.append(0)
                except exc:
                    fired.append(1)
    assert fired_a == fired_b and sum(fired_a) > 3
    assert (faults.backoff_s("feeder.put", 1, 2, base_s=0.1, cap_s=1.0)
            == jfaults.backoff_s("feeder.put", 1, 2, base_s=0.1, cap_s=1.0))
