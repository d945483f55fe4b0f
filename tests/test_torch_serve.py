"""The port's serving stack (heatmap_tpu_torch.serve) on the CPU against
the JAX package's: one seeded store written by each package (arrays,
jsonl, dir, a compacted delta store with synopses and integrals, tilefs
mirrors), the same request list through both ``ServeApp.handle``s with
status, content type, body bytes, ETag, route, cache outcome and extra
headers equal; ``/healthz`` equal up to the store path, ``/metrics``
series names equal; TileCache semantics; ``refresh_serving`` dropping
the JAX entries with the JAX count without iterating the key set; and
``LiveLayer`` keys and levels. Detail zoom 10 on small synthetic
sources."""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from heatmap_tpu import delta as jdelta
from heatmap_tpu import obs as jobs
from heatmap_tpu.io import open_sink as jopen_sink
from heatmap_tpu.io import open_source as jopen_source
from heatmap_tpu.io.sinks import LevelArraysSink as JaxLevelArraysSink
from heatmap_tpu.pipeline import batch as jbatch
from heatmap_tpu.serve import ServeApp as JApp
from heatmap_tpu.serve import TileCache as JCache
from heatmap_tpu.serve import TileStore as JStore
from heatmap_tpu.serve import degrade as jdegrade
from heatmap_tpu.tilemath.morton import morton_decode_np
from heatmap_tpu_torch import delta as tdelta
from heatmap_tpu_torch import obs as tobs
from heatmap_tpu_torch.delta import recover as trecover
from heatmap_tpu_torch.delta.compute import TileKeySet
from heatmap_tpu_torch.io import open_sink as topen_sink
from heatmap_tpu_torch.io import open_source as topen_source
from heatmap_tpu_torch.io.sinks import LevelArraysSink
from heatmap_tpu_torch.pipeline import batch as tbatch
from heatmap_tpu_torch.serve import ServeApp as TApp
from heatmap_tpu_torch.serve import TileCache as TCache
from heatmap_tpu_torch.serve import TileStore as TStore
from heatmap_tpu_torch.serve import degrade as tdegrade
from heatmap_tpu_torch.serve import serve_in_thread
from heatmap_tpu_torch.serve.store import Level

CFG = dict(detail_zoom=10, min_detail_zoom=5)


@pytest.fixture(autouse=True)
def _clear_sweep_cache():
    yield
    trecover.clear_verified_cache()


def _job(pkg, spec, source="synthetic:3000:7", **sink_kw):
    """One batch job into ``spec`` (or a LevelArraysSink(**sink_kw) at
    the ``arrays:`` path) on the CPU."""
    if pkg == "torch":
        run, cfg, open_sink, open_source, Sink = (
            tbatch.run_job, tbatch.BatchJobConfig(**CFG), topen_sink,
            topen_source, LevelArraysSink)
        kw = {"device": "cpu"}
    else:
        run, cfg, open_sink, open_source, Sink = (
            jbatch.run_job, jbatch.BatchJobConfig(**CFG), jopen_sink,
            jopen_source, JaxLevelArraysSink)
        kw = {}
    sink = (Sink(spec.partition(":")[2], **sink_kw) if sink_kw
            else open_sink(spec))
    with sink:
        run(open_source(source), sink, cfg, **kw)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{kind: (jax spec, port spec)}: each package writes its own copy."""
    root = tmp_path_factory.mktemp("torch_serve")
    out = {}
    for kind, spec, kw in (
            ("arrays", "arrays:{}/levels", {}),
            ("jsonl", "jsonl:{}/blobs.jsonl", {}),
            ("dir", "dir:{}/blobs", {}),
            ("synopsis", "arrays:{}/syn",
             {"synopses": True, "integrals": True}),
            ("tilefs", "arrays-tilefs:{}/tfs", {})):
        specs = []
        for pkg in ("jax", "torch"):
            s = spec.format(root / pkg)
            _job(pkg, s, **kw)
            specs.append(s.replace("arrays-tilefs:", "tilefs:"))
        out[kind] = tuple(specs)
    # A compacted delta store (base with synopses + integrals) plus two
    # live deltas.
    specs = []
    for pkg in ("jax", "torch"):
        d = str(root / pkg / "delta")
        mod = tdelta if pkg == "torch" else jdelta
        cfg = (tbatch if pkg == "torch" else jbatch).BatchJobConfig(**CFG)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        src = topen_source if pkg == "torch" else jopen_source
        mod.apply_batch(d, src("synthetic:2500:3"), cfg, **kw)
        mod.compact(d)
        for seed in (4, 5):
            mod.apply_batch(d, src(f"synthetic:400:{seed}"), cfg, **kw)
        specs.append(f"delta:{d}")
    out["delta"] = tuple(specs)
    return out


def _tiles(layer, n_full=6, n_empty=2):
    """Populated coarse tiles at every tile zoom of ``layer`` (both
    formats), plus empty ones."""
    out = []
    for d in layer.detail_zooms:
        z = d - layer.result_delta
        if z < 0:
            continue
        codes = np.unique(np.asarray(layer.levels[d].codes)
                          >> (2 * layer.result_delta))
        pick = codes[np.linspace(0, len(codes) - 1,
                                 min(n_full, len(codes))).astype(int)]
        r, c = morton_decode_np(np.asarray(pick, np.int64))
        cells = list(zip(c.tolist(), r.tolist()))
        n = 1 << z
        cells += [(n - 1 - i, 0) for i in range(n_empty)]
        for x, y in cells:
            for fmt in ("png", "json"):
                out.append((z, x, y, fmt))
    # Zooms the store lacks: rollup below, upsample above.
    d = layer.detail_zooms[0] - layer.result_delta - 1
    d2 = layer.detail_zooms[-1] - layer.result_delta + 1
    for z in (max(d, 0), d2):
        out.append((z, 0, 0, "json"))
    return out


def _paths(app, layer_name="default"):
    layer = app.store.layer(layer_name)
    name = layer_name.replace("|", "%7C")
    paths = [f"/tiles/{name}/{z}/{x}/{y}.{fmt}"
             for z, x, y, fmt in _tiles(layer)]
    paths += [p + "?synopsis=1" for p in paths[:12]]
    z0 = layer.detail_zooms[0]
    paths += [f"/query?layer={name}&z={z0}&bbox=0,0,{(1 << z0) - 1},"
              f"{(1 << z0) - 1}&op={op}"
              for op in ("sum", "topk&k=4", "quantile&q=0.9")]
    paths += [
        "/tiles/nope/1/0/0.png", "/tiles/default/3/99/0.json",
        "/query?z=40&bbox=0,0,1,1", "/query?bbox=0,0,1,1", "/query?z=6",
        "/query?z=6&bbox=0,0,1,1&op=median",
        "/query?op=topk_growth&z=6&window=1h",
        f"/tiles/{name}/2/1/1.png?window=1h",
        f"/tiles/{name}/2/1/1.json?as_of=5",
        "/dashboard", "/series?name=http_requests_total",
        "/series", "/series?name=x&step=-1", "/nothing",
    ]
    return paths


def _same(japp, tapp, method, path, inm=None):
    """One request through both apps: equal answers, where the bodies
    may differ only by the two stores' paths (an error naming its store,
    /healthz); the ETags are compared where they do not."""
    a = japp.handle(method, path, inm)
    b = tapp.handle(method, path, inm)
    jpath = japp.store.spec.partition(":")[2]
    tpath = tapp.store.spec.partition(":")[2]
    abody = a[2].replace(jpath.encode(), tpath.encode())
    assert (a[0], a[1], a[4], a[5]) == (b[0], b[1], b[4], b[5]), path
    assert abody == b[2], path
    if abody == a[2]:
        assert a[3] == b[3], path
    assert getattr(a, "headers", None) == getattr(b, "headers", None), path
    return a, b


def _apps(specs):
    jspec, tspec = specs
    return (JApp(JStore(jspec), JCache()), TApp(TStore(tspec), TCache()))


@pytest.mark.parametrize("kind", ["arrays", "jsonl", "dir", "synopsis",
                                  "tilefs", "delta"])
def test_every_request_answers_as_jax(stores, kind):
    """Tiles (png and json, synopsis opt-ins, rolled-up and upsampled
    zooms, empties), /query, the temporal refusals' 400s, 404s, the
    dashboard and /series: status, type, bytes, ETag, route, cache."""
    japp, tapp = _apps(stores[kind])
    assert japp.layer_names() == tapp.layer_names()
    paths = _paths(japp)
    for path in paths:
        _same(japp, tapp, "GET", path)
    # The second pass is all cache hits, 304s on the ETags.
    for path in paths:
        a, _ = _same(japp, tapp, "GET", path)
        if a[3] is not None:
            _same(japp, tapp, "GET", path, inm=a[3])
    _same(japp, tapp, "GET", "/healthz")


@pytest.mark.parametrize("kind", ["arrays", "synopsis", "delta"])
def test_every_layer_answers_as_jax(stores, kind):
    japp, tapp = _apps(stores[kind])
    for name in japp.layer_names():
        for path in _paths(japp, name)[:40]:
            _same(japp, tapp, "GET", path)


@pytest.mark.parametrize("kind", ["synopsis", "delta"])
def test_synopsis_default_and_layer_selection(stores, kind):
    jspec, tspec = stores[kind]
    layers = {"a": "all|alltime", "u": "user-1"}
    japp = JApp(JStore(jspec, layers=layers), JCache(),
                synopsis_default=True)
    tapp = TApp(TStore(tspec, layers=layers), TCache(),
                synopsis_default=True)
    assert japp.layer_names() == tapp.layer_names() == ["a", "u"]
    for path in _paths(japp, "a")[:30]:
        _same(japp, tapp, "GET", path)
        _same(japp, tapp, "GET", path.replace("?synopsis=1", "") +
              ("&" if "?" in path else "?") + "synopsis=0")
    with pytest.raises(ValueError) as je:
        JStore(jspec, layers={"x": "nobody|alltime"})
    with pytest.raises(ValueError) as te:
        TStore(tspec, layers={"x": "nobody|alltime"})
    assert str(je.value).replace(jspec, tspec) == str(te.value)


def test_store_spec_errors_and_sniffing(stores, tmp_path):
    for spec in ("nope:x", "plain-file"):
        with pytest.raises(ValueError) as je:
            JStore(spec)
        with pytest.raises(ValueError) as te:
            TStore(spec)
        assert str(je.value) == str(te.value)
    # Bare paths sniff to the same kinds.
    for kind in ("arrays", "jsonl", "dir", "tilefs", "delta"):
        jspec, tspec = stores[kind]
        jbare, tbare = jspec.partition(":")[2], tspec.partition(":")[2]
        assert JStore(jbare).kind == TStore(tbare).kind
    wp = tmp_path / "wp"
    wp.mkdir()
    (wp / "MANIFEST").write_text("{}")
    # A write-plane root with no valid manifest mounts empty in both.
    jstore, tstore = JStore(str(wp)), TStore(str(wp))
    assert jstore.kind == tstore.kind == "writeplane"
    assert jstore.delta_epoch == tstore.delta_epoch == 0
    assert sorted(jstore.layers) == sorted(tstore.layers)


@pytest.mark.parametrize("kind", ["arrays", "delta"])
def test_reload_and_degraded_paths_answer_as_jax(stores, kind):
    from heatmap_tpu import faults as jfaults
    from heatmap_tpu_torch import faults as tfaults

    japp, tapp = _apps(stores[kind])
    path = _paths(japp)[0]
    _same(japp, tapp, "GET", path)
    _same(japp, tapp, "POST", "/reload")
    _same(japp, tapp, "POST", "/drain")
    _same(japp, tapp, "GET", path)
    _same(japp, tapp, "POST", "/undrain")
    _same(japp, tapp, "GET", path)
    # Injected render faults: stale-200 from the cache, then a typed 503
    # for a tile with no last-good bytes.
    spec = "seed=3,scale=0,tile.render=100"
    jfaults.install_spec(spec)
    tfaults.install_spec(spec)
    try:
        _same(japp, tapp, "POST", "/reload")
        _same(japp, tapp, "GET", path)
        _same(japp, tapp, "GET", _paths(japp)[3])
        _same(japp, tapp, "GET", "/healthz")
    finally:
        jfaults.install(None)
        tfaults.install(None)


@pytest.mark.parametrize("rung", [0, 1, 2, 3])
def test_brownout_rungs_answer_as_jax(stores, rung):
    jspec, tspec = stores["synopsis"]
    apps = []
    for store, app_cls, cache, mod in ((JStore(jspec), JApp, JCache,
                                        jdegrade),
                                       (TStore(tspec), TApp, TCache,
                                        tdegrade)):
        ctl = mod.BrownoutController(burn_source=lambda: {"p": 0.75},
                                     poll_interval_s=0.0, shed_fraction=0.5)
        ctl.rung = rung
        apps.append(app_cls(store, cache(ttl_s=30.0), max_inflight=8,
                            degrade=ctl))
    japp, tapp = apps
    for path in _paths(japp)[:50]:
        _same(japp, tapp, "GET", path)
    _same(japp, tapp, "GET", "/healthz")
    assert japp.cache.ttl_scale == tapp.cache.ttl_scale


def test_metrics_series_names_match(stores):
    """/metrics over the same requests names the same series."""
    japp, tapp = _apps(stores["arrays"])
    for mod in (jobs, tobs):
        mod.get_registry().reset()
        mod.enable_metrics(True)
    try:
        for path in _paths(japp)[:20]:
            _same(japp, tapp, "GET", path)

        def names(app):
            body = app.handle("GET", "/metrics")[2].decode()
            return sorted({ln.split("{")[0].split(" ")[0]
                           for ln in body.splitlines()
                           if ln and not ln.startswith("#")})

        got, want = names(tapp), names(japp)
        assert got == want
        assert "tile_cache_misses_total" in got
        assert "process_uptime_seconds" in got
    finally:
        for mod in (jobs, tobs):
            mod.enable_metrics(False)
            mod.get_registry().reset()


def test_http_shell_headers_and_bodies(stores):
    """Over loopback sockets: the port's server sends the JAX server's
    status, body, ETag, content type and length."""
    from heatmap_tpu.serve import serve_in_thread as jserve_in_thread

    japp, tapp = _apps(stores["arrays"])
    jsrv, jbase = jserve_in_thread(japp)
    tsrv, tbase = serve_in_thread(tapp)

    def get(url, **headers):
        req = urllib.request.Request(url, headers=headers)
        try:
            with urllib.request.urlopen(req) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    try:
        for path in _paths(japp)[:24] + ["/nothing"]:
            a, b = get(jbase + path), get(tbase + path)
            assert (a[0], a[2]) == (b[0], b[2]), path
            for h in ("ETag", "Content-Type", "Content-Length",
                      "X-Heatmap-Synopsis"):
                assert a[1].get(h) == b[1].get(h), (path, h)
            if a[1].get("ETag"):
                c = get(tbase + path, **{"If-None-Match": a[1]["ETag"]})
                assert c[0] == 304 and c[2] == b""
    finally:
        for srv in (jsrv, tsrv):
            srv.shutdown()
            srv.server_close()


# -- TileCache ---------------------------------------------------------------


def test_cache_lru_ttl_generation_and_stale_if_error():
    for Cache in (JCache, TCache):
        now = [0.0]
        cache = Cache(max_bytes=10, ttl_s=5.0, clock=lambda: now[0])
        assert cache.get_or_render("a", 0, lambda: b"aaaa") == (b"aaaa",
                                                               False)
        assert cache.get_or_render("a", 0, lambda: b"x") == (b"aaaa", True)
        cache.get_or_render("b", 0, lambda: b"bbbb")
        cache.get_or_render("c", 0, lambda: b"cccc")
        assert len(cache) == 2 and cache.nbytes == 8  # "a" evicted by LRU
        now[0] = 6.0
        assert cache.get_or_render("b", 0, lambda: b"BBBB")[1] is False
        assert cache.get_or_render("b", 1, lambda: b"bb")[0] == b"bb"

        def boom():
            raise RuntimeError("render down")

        assert cache.get_or_render("b", 2, boom, stale_if_error=True) == (
            b"bb", Cache.STALE)
        with pytest.raises(RuntimeError):
            cache.get_or_render("z", 0, boom)
        assert cache.invalidate_keys(["b", "c", "q"]) == 2
        assert len(cache) == 0


def test_cache_single_flight_renders_once():
    for Cache in (JCache, TCache):
        cache = Cache()
        gate = threading.Event()
        calls = []

        def render():
            calls.append(1)
            gate.wait(5)
            return b"tile"

        out = []
        threads = [threading.Thread(
            target=lambda: out.append(cache.get_or_render("k", 0, render)))
            for _ in range(8)]
        for t in threads:
            t.start()
        while not cache._flights:
            pass
        gate.set()
        for t in threads:
            t.join()
        assert len(calls) == 1 and sorted(h for _, h in out) == [False] + [
            True] * 7


def test_invalidate_matching_drops_what_invalidate_keys_drops():
    keys = {("default", 3, 1, 2, "png"), ("default", 3, 1, 2, "json"),
            ("l", 0, 0, 0, "png")}
    a, b, c = JCache(), TCache(), TCache()
    fill = [("default", 3, 1, 2, "png"), ("default", 3, 1, 3, "png"),
            ("l", 0, 0, 0, "png"), ("l", 0, 0, 0, "png", "w", "1h"),
            ("l", 0, 0, 0, "png", "w", "1d"), ("query", "l", 3)]
    for cache in (a, b, c):
        for k in fill:
            cache.get_or_render(k, 0, lambda: b"x")
    params = ("1h",)
    with_windows = keys | {k + ("w", p) for k in keys for p in params}
    want = a.invalidate_keys(with_windows)
    assert b.invalidate_matching(keys, params) == want == 3
    assert c.invalidate_keys(with_windows) == want
    assert list(a._entries) == list(b._entries) == list(c._entries)


def test_invalidate_matching_skips_an_inflight_render():
    cache = TCache()
    gate, started = threading.Event(), threading.Event()

    def render():
        started.set()
        gate.wait(5)
        return b"old bytes"

    t = threading.Thread(target=cache.get_or_render, args=("k", 0, render))
    t.start()
    started.wait(5)
    assert cache.invalidate_matching({"k"}) == 0
    gate.set()
    t.join()
    assert len(cache) == 0  # the doomed flight's bytes were not cached
    assert cache.get_or_render("k", 0, lambda: b"new")[0] == b"new"


# -- refresh_serving -----------------------------------------------------------


def _delta_pair(tmp_path, base_points=2000):
    roots = {}
    for pkg, mod, bmod, src, kw in (
            ("jax", jdelta, jbatch, jopen_source, {}),
            ("torch", tdelta, tbatch, topen_source, {"device": "cpu"})):
        root = str(tmp_path / pkg)
        mod.apply_batch(root, src(f"synthetic:{base_points}:11"),
                        bmod.BatchJobConfig(**CFG), **kw)
        mod.compact(root)
        roots[pkg] = root
    return roots


def test_refresh_serving_drops_the_jax_entries(tmp_path):
    """Same requests fill both caches; the same increment applied to
    both stores; refresh_serving returns the JAX count, leaves the same
    entries, and every tile then answers with the JAX bytes."""
    roots = _delta_pair(tmp_path)
    japp = JApp(JStore(f"delta:{roots['jax']}"), JCache())
    tapp = TApp(TStore(f"delta:{roots['torch']}"), TCache())
    paths = []
    for name in japp.layer_names():
        paths += _paths(japp, name)[:60]
    for path in paths:
        _same(japp, tapp, "GET", path)
    jres = jdelta.apply_batch(roots["jax"], jopen_source("synthetic:300:12"),
                              jbatch.BatchJobConfig(**CFG))
    tres = tdelta.apply_batch(roots["torch"],
                              topen_source("synthetic:300:12"),
                              tbatch.BatchJobConfig(**CFG), device="cpu")
    assert isinstance(tres.affected_keys, TileKeySet)
    assert set(tres.affected_keys) == jres.affected_keys
    n = jdelta.refresh_serving(jres, japp.store, japp.cache)
    assert tdelta.refresh_serving(tres, tapp.store, tapp.cache) == n > 0
    assert list(japp.cache._entries) == list(tapp.cache._entries)
    for path in paths:
        _same(japp, tapp, "GET", path)
    # A duplicate publishes nothing.
    dup = tdelta.apply_batch(roots["torch"], topen_source("synthetic:300:12"),
                             tbatch.BatchJobConfig(**CFG), device="cpu")
    assert dup.duplicate and tdelta.refresh_serving(dup, tapp.store,
                                                    tapp.cache) == 0


def test_refresh_serving_never_iterates_the_key_set(tmp_path, monkeypatch):
    """The port's refresh walks the cache and tests membership: a
    TileKeySet that refuses iteration still gets its entries dropped."""
    roots = _delta_pair(tmp_path, base_points=800)
    tapp = TApp(TStore(f"delta:{roots['torch']}"), TCache())
    for path in _paths(tapp)[:40]:
        tapp.handle("GET", path)
    before = len(tapp.cache)
    res = tdelta.apply_batch(roots["torch"], topen_source("synthetic:200:13"),
                             tbatch.BatchJobConfig(**CFG), device="cpu")

    def refuse(self):
        raise AssertionError("refresh_serving iterated the TileKeySet")

    monkeypatch.setattr(TileKeySet, "__iter__", refuse)
    dropped = tdelta.refresh_serving(res, tapp.store, tapp.cache)
    assert 0 < dropped <= before and len(tapp.cache) == before - dropped


def test_publish_provisional_matches_jax(stores):
    """The early-serving overlay over synopsis views: the same views
    updated, the same stale-marked synopsis tiles."""
    from heatmap_tpu.ingest import loop as jloop
    from heatmap_tpu_torch.ingest import loop as tloop

    japp, tapp = _apps(stores["delta"])
    jcfg, tcfg = jbatch.BatchJobConfig(**CFG), tbatch.BatchJobConfig(**CFG)
    jcols = jdelta.read_columns(jopen_source("synthetic:300:21"))
    tcols = tdelta.read_columns(topen_source("synthetic:300:21"))
    jrows = jloop._provisional_rows(japp.store, jcols, jcfg, 1)
    trows = tloop._provisional_rows(tapp.store, tcols, tcfg, 1)
    assert jrows.keys() == trows.keys() and jrows
    for pair in jrows:
        assert jrows[pair].keys() == trows[pair].keys()
        for z in jrows[pair]:
            for a, b in zip(jrows[pair][z], trows[pair][z]):
                np.testing.assert_array_equal(a, b)
    assert (japp.store.publish_provisional(jrows)
            == tapp.store.publish_provisional(trows) > 0)
    for path in _paths(japp)[:30]:
        if "synopsis=1" in path:
            _same(japp, tapp, "GET", path)


# -- LiveLayer ---------------------------------------------------------------


def test_live_layer_keys_and_levels_match_jax():
    from heatmap_tpu.ops import Window as JWindow
    from heatmap_tpu.serve import LiveLayer as JLive
    from heatmap_tpu.streaming import HeatmapStream as JStream
    from heatmap_tpu.streaming import StreamConfig as JConfig
    from heatmap_tpu_torch.ops.histogram import Window
    from heatmap_tpu_torch.serve import LiveLayer
    from heatmap_tpu_torch.streaming import HeatmapStream, StreamConfig

    jw = JWindow(zoom=10, row0=352, col0=160, height=32, width=64)
    tw = Window(zoom=10, row0=352, col0=160, height=32, width=64)
    jl = JLive(JStream(JConfig(window=jw, half_life_s=120.0, pad_to=512)),
               name="live")
    tl = LiveLayer(HeatmapStream(StreamConfig(window=tw, half_life_s=120.0,
                                              pad_to=512), device="cpu"),
                   name="live")
    assert tl.result_delta == jl.result_delta == 5
    rng = np.random.default_rng(3)
    japp = JApp(JStore(_empty_store()), JCache())
    tapp = TApp(TStore(_empty_store()), TCache())
    japp.attach_layer("live", jl)
    tapp.attach_layer("live", tl)
    for i in range(4):
        lat = rng.uniform(46.5, 47.8, 400)
        lon = rng.uniform(-123.0, -121.0, 400)
        jk = jl.tick(lat, lon, t=60.0 * i)
        tk = tl.tick(lat, lon, t=60.0 * i)
        assert isinstance(tk, TileKeySet) and set(tk) == jk and len(tk) == len(
            jk)
        for z in jl.levels:
            np.testing.assert_array_equal(jl.levels[z].codes,
                                          tl.levels[z].codes)
            np.testing.assert_array_equal(jl.levels[z].values,
                                          tl.levels[z].values)
        for key in sorted(jk, key=str)[:40]:
            _, z, x, y, fmt = key
            _same(japp, tapp, "GET", f"/tiles/live/{z}/{x}/{y}.{fmt}")
        assert (japp.cache.invalidate_keys(jk)
                == tapp.cache.invalidate_matching(tk))
    _same(japp, tapp, "GET", "/healthz")


_EMPTY = {}


def _empty_store():
    """A one-point arrays store (the live tests only need a mount)."""
    import tempfile

    if "spec" not in _EMPTY:
        d = tempfile.mkdtemp(prefix="torch_serve_empty_")
        _job("torch", f"arrays:{d}", source="synthetic:10:1")
        _EMPTY["spec"] = f"arrays:{d}"
    return _EMPTY["spec"]


def test_level_contract_matches_jax():
    from heatmap_tpu.serve.store import Level as JLevel

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 1 << 20, 500)
    values = rng.random(500)
    a, b = JLevel(10, codes, values), Level(10, codes, values)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.vmax == b.vmax
    for lo, hi in ((0, 1 << 10), (1 << 12, 1 << 16), (5, 5)):
        for x, y in zip(a.range(lo, hi), b.range(lo, hi)):
            np.testing.assert_array_equal(x, y)
    for code in codes[:20].tolist() + [-1, 1 << 21]:
        assert a.lookup(code) == b.lookup(code)


def test_temporal_params_on_a_temporal_store_are_refused(stores, tmp_path):
    """On a store that pins a temporal config, temporal tile and query
    parameters (ported since: temporal/) answer with the JAX app's
    status, body, ETag and headers over the same store, before and after
    a bucketed compaction; malformed ones keep the JAX 400s, and the
    all-time tiles still answer as the JAX package's."""
    import shutil

    from heatmap_tpu_torch.temporal import fold as tfold

    jspec, tspec = stores["delta"]
    root = str(tmp_path / "temporal")
    jroot = str(tmp_path / "jtemporal")
    shutil.copytree(tspec.partition(":")[2], root)
    shutil.copytree(jspec.partition(":")[2], jroot)
    for r in (root, jroot):
        tfold.ensure_config(r, width=3600)
    paths = ["/tiles/default/2/1/1.png?window=1h",
             "/tiles/default/2/1/1.json?as_of=5&decay=1d",
             "/tiles/default/2/1/1.json?as_of=1e12",
             "/query?op=topk_growth&z=6&window=1h",
             "/query?op=topk_growth&window=1h",
             "/tiles/default/2/1/1.json?window=bogus"]
    for step in ("live", "compacted"):
        if step == "compacted":
            assert (tdelta.compact(root)["buckets"]
                    == jdelta.compact(jroot)["buckets"])
        tapp = TApp(TStore(f"delta:{root}"), TCache())
        japp = JApp(JStore(f"delta:{jroot}"), JCache())
        for path in paths + _paths(japp)[:10]:
            a, b = japp.handle("GET", path), tapp.handle("GET", path)
            assert (a[0], a[1], a[2], a[3], a[5]) == (
                b[0], b[1], b[2], b[3], b[5]), (step, path)
            assert getattr(a, "headers", None) == getattr(
                b, "headers", None), (step, path)
        assert tapp.handle("GET", paths[4])[0] == 400
