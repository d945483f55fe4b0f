"""The port's stream (``heatmap_tpu_torch.streaming``) and tick pump
(``heatmap_tpu_torch.ingest.run_ticks``) on the CPU, against the JAX
package's ``HeatmapStream`` and ``decayed_oracle`` on the same seeded
points (``tests/test_streaming.py``'s window and timed batches):
float64 accumulation within ``rtol=1e-12`` of the oracle, float32
within ``rtol=1e-5`` of the JAX stream (the decay factor's ``exp`` may
round an ulp apart), bit-equal without decay; padding, refusals,
checkpoints across the two packages, and the pump's back-pressure."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatmap_tpu import streaming as jst
from heatmap_tpu.ingest.loop import run_ticks as jax_run_ticks
from heatmap_tpu.ops import Window as JaxWindow
from heatmap_tpu.utils import CheckpointManager as JaxCheckpointManager
from heatmap_tpu_torch import streaming as tst
from heatmap_tpu_torch.ingest import TickContext, run_ticks
from heatmap_tpu_torch.ops.histogram import Window
from heatmap_tpu_torch.utils import CheckpointManager
from test_streaming import WINDOW as JAX_WINDOW
from test_streaming import _timed_points

WINDOW = Window(JAX_WINDOW.zoom, JAX_WINDOW.row0, JAX_WINDOW.col0,
                JAX_WINDOW.height, JAX_WINDOW.width)
BACKENDS = ("auto", "xla", "pallas", "partitioned")


def _port(half_life, acc=torch.float64, backend="auto", pad_to=None,
          window=WINDOW):
    return tst.HeatmapStream(tst.StreamConfig(
        window=window, half_life_s=half_life, proj_dtype=torch.float64,
        acc_dtype=acc, pad_to=pad_to, backend=backend), device="cpu")


def _jax(half_life, acc=jnp.float64, pad_to=None, window=JAX_WINDOW):
    return jst.HeatmapStream(jst.StreamConfig(
        window=window, half_life_s=half_life, proj_dtype=jnp.float64,
        acc_dtype=acc, pad_to=pad_to))


def _feed(stream, pts, weights=None):
    for i, (t, lat, lon) in enumerate(pts):
        stream.update(lat, lon, t,
                      weights=None if weights is None else weights[i])
    return stream


@pytest.mark.parametrize("backend", BACKENDS)
def test_f64_matches_oracle(backend):
    pts = _timed_points()
    got = _feed(_port(600.0, backend=backend), pts).snapshot()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, jst.decayed_oracle(JAX_WINDOW, pts, 600.0),
                               rtol=1e-12)
    np.testing.assert_allclose(got, tst.decayed_oracle(WINDOW, pts, 600.0),
                               rtol=1e-12)


@pytest.mark.parametrize("half_life", [300.0, 600.0, 3600.0])
def test_f32_matches_jax_stream(half_life):
    pts = _timed_points(6, n=2000, seed=3)
    got = _feed(_port(half_life, acc=torch.float32), pts).snapshot()
    want = _feed(_jax(half_life, acc=jnp.float32), pts).snapshot()
    assert got.dtype == want.dtype == np.float32
    assert want.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_decay_f32_bit_equal_to_jax(backend):
    """Without decay the float32 factor is exactly 1 on both sides, so
    counts accumulate exactly. (At float64 the factor 2^(-dt/1e18) sits
    an ulp below 1 and XLA's fused multiply-add rounds once where the
    port rounds twice: the f64 cases are held to the oracle above.)"""
    pts = _timed_points(3)
    got = _feed(_port(1e18, acc=torch.float32, backend=backend),
                pts).snapshot()
    want = _feed(_jax(1e18, acc=jnp.float32), pts).snapshot()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # The oracle's float64 decay 2^(-dt/1e18) sits an ulp below 1.
    np.testing.assert_allclose(
        got, jst.decayed_oracle(JAX_WINDOW, pts, 1e18), rtol=1e-12)


def test_fixed_interval_f32_bit_equal_to_jax():
    """A fixed tick interval (the ``stream`` command's cadence) at the
    half-lives of the CLI tests: the float32 decay factor rounds the same
    in torch and XLA there, and the fused multiply-add is reproduced, so
    the rasters are bit-equal."""
    pts = [(600.0 * (i + 1), lat, lon)
           for i, (_, lat, lon) in enumerate(_timed_points(6, n=3000))]
    for hl in (1200.0, 3600.0):
        got = _feed(_port(hl, acc=torch.float32), pts).snapshot()
        want = _feed(_jax(hl, acc=jnp.float32), pts).snapshot()
        np.testing.assert_array_equal(got, want)


def test_weighted_integer_no_decay_bit_equal_to_jax():
    pts = _timed_points(4, n=500, seed=4)
    rng = np.random.default_rng(4)
    weights = [rng.integers(0, 50, len(lat)).astype(np.float64)
               for _, lat, _ in pts]
    for backend in BACKENDS:
        got = _feed(_port(1e18, acc=torch.float32, backend=backend), pts,
                    weights).snapshot()
        want = _feed(_jax(1e18, acc=jnp.float32), pts, weights).snapshot()
        np.testing.assert_array_equal(got, want)


def test_decay_halves_after_half_life():
    stream = _port(100.0)
    stream.update(np.array([41.0]), np.array([-80.0]), 0.0)
    total0 = stream.snapshot().sum()
    stream.update(np.empty(0), np.empty(0), 100.0)
    np.testing.assert_allclose(stream.snapshot().sum(), total0 / 2,
                               rtol=1e-12)


def test_pad_to_matches_oracle_and_refuses_overflow():
    pts = _timed_points(4, n=400, seed=2)
    stream = _feed(_port(500.0, pad_to=512), pts)
    np.testing.assert_allclose(
        stream.snapshot(), jst.decayed_oracle(JAX_WINDOW, pts, 500.0),
        rtol=1e-12)
    with pytest.raises(ValueError, match="pad_to") as got:
        stream.update(np.zeros(513), np.zeros(513), 1e6)
    jax_stream = _feed(_jax(500.0, pad_to=512), pts)
    with pytest.raises(ValueError) as want:
        jax_stream.update(np.zeros(513), np.zeros(513), 1e6)
    assert str(got.value) == str(want.value)


def test_padded_weights_are_masked():
    """Padding lanes carry zero weight and a false valid bit: a padded
    weighted stream equals the unpadded one."""
    pts = _timed_points(3, n=300, seed=6)
    w = [np.full(len(lat), 3.0) for _, lat, _ in pts]
    padded = _feed(_port(900.0, pad_to=1024), pts, w).snapshot()
    plain = _feed(_port(900.0), pts, w).snapshot()
    np.testing.assert_array_equal(padded, plain)


def test_time_going_backwards_rejected_like_jax():
    stream = _port(3600.0)
    stream.update(np.array([41.0]), np.array([-80.0]), 10.0)
    with pytest.raises(ValueError, match="backwards") as got:
        stream.update(np.array([41.0]), np.array([-80.0]), 5.0)
    jax_stream = _jax(3600.0)
    jax_stream.update(np.array([41.0]), np.array([-80.0]), 10.0)
    with pytest.raises(ValueError) as want:
        jax_stream.update(np.array([41.0]), np.array([-80.0]), 5.0)
    assert str(got.value) == str(want.value)


def test_update_is_in_place_and_snapshot_is_a_copy():
    stream = _port(600.0, acc=torch.float32)
    raster = stream.raster
    ptr = raster.data_ptr()
    pts = _timed_points(3)
    stream.update(pts[0][1], pts[0][2], pts[0][0])
    snap = stream.snapshot()
    before = snap.copy()
    for t, lat, lon in pts[1:]:
        stream.update(lat, lon, t)
    assert stream.raster is raster and raster.data_ptr() == ptr
    np.testing.assert_array_equal(snap, before)
    assert stream.n_batches == 3 and stream.t == pts[-1][0]


def test_run_stream_drops_background_rows():
    batches = [(0.0, {
        "latitude": np.array([41.0, 41.2]),
        "longitude": np.array([-80.0, -81.0]),
        "user_id": ["a", "b"],
        "source": ["gps", "background"],
        "timestamp": [None, None],
    })]
    seen = []
    stream = tst.run_stream(_port(1e18), batches,
                            on_batch=lambda s, t: seen.append(t))
    assert stream.snapshot().sum() == 1.0
    assert seen == [0.0]
    want = jst.run_stream(_jax(1e18), batches, on_batch=lambda s, t: None)
    np.testing.assert_array_equal(stream.snapshot(), want.snapshot())
    # The default hook is a no-op.
    assert tst.run_stream(_port(1e18), batches).n_batches == 1


def test_state_dict_resume_reproduces_stream():
    pts = _timed_points(6, seed=9)
    full = _feed(_port(300.0, acc=torch.float32), pts)
    first = _feed(_port(300.0, acc=torch.float32), pts[:3])
    resumed = _port(300.0, acc=torch.float32).load_state_dict(
        first.state_dict())
    _feed(resumed, pts[3:])
    np.testing.assert_array_equal(resumed.snapshot(), full.snapshot())
    assert resumed.n_batches == full.n_batches == 6


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A checkpoint written by one package's ``HeatmapStream.checkpoint``
    resumes in the other, and the resumed stream equals an
    uninterrupted JAX stream."""
    pts = _timed_points(6, seed=11)
    want = _feed(_jax(400.0), pts).snapshot()
    first = (_jax(400.0) if writer == "jax" else _port(400.0))
    _feed(first, pts[:3])
    mgr_cls = JaxCheckpointManager if writer == "jax" else CheckpointManager
    first.checkpoint(mgr_cls(str(tmp_path)), weighted=False)
    if writer == "jax":
        resumed = _port(400.0).restore(CheckpointManager(str(tmp_path)),
                                       weighted=False)
    else:
        resumed = _jax(400.0).restore(JaxCheckpointManager(str(tmp_path)),
                                      weighted=False)
    assert resumed.n_batches == 3 and resumed.t == pts[2][0]
    _feed(resumed, pts[3:])
    np.testing.assert_allclose(resumed.snapshot(), want, rtol=1e-12)


def test_checkpoint_no_decay_f32_bit_equal_across_packages(tmp_path):
    pts = _timed_points(4, seed=12)
    want = _feed(_jax(1e18, acc=jnp.float32), pts).snapshot()
    first = _feed(_jax(1e18, acc=jnp.float32), pts[:2])
    first.checkpoint(JaxCheckpointManager(str(tmp_path)))
    resumed = _port(1e18, acc=torch.float32).restore(
        CheckpointManager(str(tmp_path)))
    np.testing.assert_array_equal(_feed(resumed, pts[2:]).snapshot(), want)


def _refusal(make_stream, window_cls, mgr_cls, root, kind):
    """The error of a restore that must be refused: into a shifted
    window, or a weighted checkpoint resumed as counted."""
    win = window_cls(zoom=10, row0=256, col0=256, height=128, width=128)
    s = make_stream(win)
    s.update(np.full(10, 47.6), np.full(10, -122.3), 1.0,
             weights=np.full(10, 3.0))
    mgr = mgr_cls(str(root))
    s.checkpoint(mgr, weighted=True)
    with pytest.raises(ValueError) as err:
        if kind == "window":
            make_stream(window_cls(zoom=10, row0=384, col0=256, height=128,
                                   width=128)).restore(mgr)
        else:
            make_stream(win).restore(mgr, weighted=False)
    return str(err.value)


@pytest.mark.parametrize("kind", ["window", "weighted"])
def test_restore_refusals_word_for_word(tmp_path, kind):
    got = _refusal(lambda w: tst.HeatmapStream(
        tst.StreamConfig(window=w, half_life_s=10.0), device="cpu"),
        Window, CheckpointManager, tmp_path / "port", kind)
    want = _refusal(lambda w: jst.HeatmapStream(
        jst.StreamConfig(window=w, half_life_s=10.0)),
        JaxWindow, JaxCheckpointManager, tmp_path / "jax", kind)
    assert got == want
    assert kind in got


def test_restore_accepts_matching_and_unrecorded_modes(tmp_path):
    win = Window(zoom=10, row0=256, col0=256, height=128, width=128)
    cfg = tst.StreamConfig(window=win, half_life_s=10.0)
    s = tst.HeatmapStream(cfg, device="cpu")
    s.update(np.full(10, 47.6), np.full(10, -122.3), 1.0,
             weights=np.full(10, 3.0))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    s.checkpoint(mgr, weighted=True)
    s2 = tst.HeatmapStream(cfg, device="cpu").restore(mgr, weighted=True)
    assert s2.n_batches == 1 and s2.t == 1.0
    mgr2 = CheckpointManager(str(tmp_path / "ck2"))
    s.checkpoint(mgr2)
    tst.HeatmapStream(cfg, device="cpu").restore(mgr2, weighted=False)
    with pytest.raises(ValueError, match="checkpoint raster"):
        tst.HeatmapStream(tst.StreamConfig(window=WINDOW),
                          device="cpu").load_state_dict(s.state_dict())


def test_sharded_step_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tst.make_update_step(tst.StreamConfig(window=WINDOW), mesh=object())


def test_stream_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.HeatmapStream(tst.StreamConfig(window=WINDOW))


def test_decay_rate_and_oracle_are_the_jax_packages():
    cfg = tst.StreamConfig(window=WINDOW, half_life_s=1234.5)
    assert cfg.decay_rate == jst.StreamConfig(
        window=JAX_WINDOW, half_life_s=1234.5).decay_rate
    assert cfg.proj_dtype == cfg.acc_dtype == torch.float32
    pts = _timed_points(4, seed=1)
    np.testing.assert_array_equal(tst.decayed_oracle(WINDOW, pts, 777.0),
                                  jst.decayed_oracle(JAX_WINDOW, pts, 777.0))


# -- the tick pump --------------------------------------------------------


def test_run_ticks_sync_matches_jax():
    seen = []
    stats = run_ticks(range(5), lambda item, ctx: seen.append(
        (item, ctx.index, ctx.queue_depth)))
    jseen = []
    jstats = jax_run_ticks(range(5), lambda item, ctx: jseen.append(
        (item, ctx.index, ctx.queue_depth)))
    assert stats == jstats == {"ticks": 5, "max_queue_depth": 0}
    assert seen == jseen


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_run_ticks_back_pressure(depth):
    """A slow consumer never has more than ``depth`` items resident, and
    the producer runs at most ``depth`` items (plus the one it holds)
    ahead of the ticks."""
    produced = []
    lead = []
    lock = threading.Lock()
    consumed = [0]

    def items():
        for i in range(20):
            with lock:
                produced.append(i)
                lead.append(len(produced) - consumed[0])
            yield i

    def tick(item, ctx):
        assert isinstance(ctx, TickContext) and ctx.index == item
        time.sleep(0.005)
        with lock:
            consumed[0] += 1

    stats = run_ticks(items(), tick, queue_depth=depth)
    assert stats["ticks"] == 20
    assert 1 <= stats["max_queue_depth"] <= depth
    assert max(lead) <= depth + 2


def test_run_ticks_reraises_producer_error():
    def items():
        yield 1
        yield 2
        raise OSError("source died")

    seen = []
    with pytest.raises(OSError, match="source died"):
        run_ticks(items(), lambda item, ctx: seen.append(item),
                  queue_depth=2)
    assert seen == [1, 2]


def test_run_ticks_tick_error_stops_producer():
    pulled = []

    def items():
        for i in range(1000):
            pulled.append(i)
            yield i

    def tick(item, ctx):
        if item == 3:
            raise KeyError("bad tick")

    with pytest.raises(KeyError, match="bad tick"):
        run_ticks(items(), tick, queue_depth=2, name="t")
    assert len(pulled) < 20
    assert not any(t.name == "t-producer" and t.is_alive()
                   for t in threading.enumerate())


def test_run_ticks_refuses_zero_depth():
    with pytest.raises(ValueError, match="queue_depth"):
        run_ticks([1], lambda item, ctx: None, queue_depth=0)
