"""The port's serving commands on the CPU against the JAX package's:
``render`` (the same PNG trees and summary keys), ``ingest --serve-port
0`` (the same summary and store, and tiles fetched from the live server
after every applied tick equal to a cold mount's), ``serve`` (banner
keys, the same bytes over HTTP, no CUDA touched) and ``serve
--follow-stream`` (the live layer the JAX pump builds), and the
parsing of ``serve --fleet`` with the router's flags and of
``writeplane`` against the JAX parser."""

import json
import os
import pathlib
import urllib.error
import urllib.request

import numpy as np
import pytest

from heatmap_tpu import cli as jcli
from heatmap_tpu.pipeline import bucketing as jbucketing
from heatmap_tpu.serve import ServeApp as JApp
from heatmap_tpu.serve import TileCache as JCache
from heatmap_tpu.serve import TileStore as JStore
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import delta as tdelta
from heatmap_tpu_torch import obs as tobs
from heatmap_tpu_torch.delta import recover as trecover
from heatmap_tpu_torch.pipeline import bucketing as tbucketing
from heatmap_tpu_torch.serve import ServeApp as TApp
from heatmap_tpu_torch.serve import TileCache as TCache
from heatmap_tpu_torch.serve import TileStore as TStore


@pytest.fixture(autouse=True)
def _clear_sweep_cache():
    yield
    trecover.clear_verified_cache()
    # ``serve`` turns the registry on for /metrics, as the JAX one does.
    tobs.enable_metrics(False)
    tobs.get_registry().reset()


def _tree(root):
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _store_tree(root):
    """Every file of a delta store but the journal entries (their meta
    holds the wall-clock ``ts``)."""
    return {k: v for k, v in _tree(root).items()
            if not k.startswith("journal" + os.sep)}


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _get(url):
    try:
        with urllib.request.urlopen(url) as resp:
            return resp.status, resp.headers.get("ETag"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("ETag"), e.read()


@pytest.fixture(scope="module")
def levels(tmp_path_factory):
    root = tmp_path_factory.mktemp("render_levels")
    argv = ["run", "--input", "synthetic:4000:6", "--backend", "cpu",
            "--detail-zoom", "12", "--timespans", "alltime,month"]
    assert tcli.main([*argv, "--output", f"arrays:{root}/arrays"]) == 0
    assert tcli.main([*argv, "--output", f"jsonl:{root}/blobs.jsonl"]) == 0
    return root


@pytest.mark.parametrize("source,extra", [
    ("arrays", []), ("arrays", ["--zoom", "9", "--pixel-delta", "4"]),
    ("arrays", ["--user", "user-2"]), ("jsonl", []),
    ("jsonl", ["--zoom", "10", "--pixel-delta", "20"]),
    ("arrays", ["--user", "nobody"])])
def test_render_writes_the_jax_tree(levels, tmp_path, capsys, source,
                                    extra):
    spec = (f"arrays:{levels}/arrays" if source == "arrays"
            else f"jsonl:{levels}/blobs.jsonl")
    argv = ["render", "--input", spec, *extra]
    assert tcli.main([*argv, "--output", str(tmp_path / "t")]) == 0
    got = _last_json(capsys.readouterr().out)
    assert jcli.main([*argv, "--output", str(tmp_path / "j")]) == 0
    want = _last_json(capsys.readouterr().out)
    assert list(got) == [*want, "device"] and got["device"] is None
    for k in want:
        if k not in ("seconds", "output"):
            assert got[k] == want[k], k
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


@pytest.mark.parametrize("argv", [
    ["render", "--input", "csv:x.csv"],
    ["render", "--input", "arrays:{levels}/arrays", "--zoom", "3"]])
def test_render_errors_match_jax(levels, argv):
    argv = [a.format(levels=levels) for a in argv]
    with pytest.raises(SystemExit) as te:
        tcli.main(argv)
    with pytest.raises(SystemExit) as je:
        jcli.main(argv)
    assert str(te.value) == str(je.value)


def _ingest_argv(root, *extra):
    return ["ingest", "--journal", str(root), "--input", "synthetic:3000:5",
            "--detail-zoom", "10", "--micro-batch", "700",
            "--compact-every", "3", "--serve-port", "0", "--backend", "cpu",
            *extra]


@pytest.mark.parametrize("extra", [[], ["--queue-depth", "0"]])
def test_ingest_serve_port_matches_jax(tmp_path, capsys, extra):
    """The summary keys (``serving`` after ``journal``) and values, the
    store, and the published count equal the JAX command's."""
    tbucketing.reset_cache_stats()
    assert tcli.main(_ingest_argv(tmp_path / "t", *extra)) == 0
    out = capsys.readouterr()
    got = _last_json(out.out)
    assert "while ingesting" in out.err
    jbucketing.reset_cache_stats()
    assert jcli.main(_ingest_argv(tmp_path / "j", *extra)) == 0
    want = _last_json(capsys.readouterr().out)
    assert list(got) == [*want, "device"] and got["device"] == "cpu"
    assert list(got)[:2] == ["journal", "serving"]
    assert got["serving"].startswith("http://127.0.0.1:")
    for k in want:
        if k in ("journal", "seconds", "serving"):
            continue
        if k == "max_queue_depth" and not extra:
            for v in (got[k], want[k]):
                assert 1 <= v <= 4 + 1
            continue
        assert got[k] == want[k], k
    assert got["keys_invalidated"] == 0  # nothing fetched, nothing cached
    assert _store_tree(tmp_path / "t") == _store_tree(tmp_path / "j")


def test_ingest_serve_port_serves_fresh_tiles(tmp_path, capsys,
                                             monkeypatch):
    """While the drain runs, a client fills the live server's cache;
    after every applied tick each cached tile the tick touched, and
    every JSON tile, is re-fetched and equals a cold mount's bytes, and
    the invalidated count is the JAX count for the same cache. (An
    untouched PNG tile can keep its old bytes: its colormap scales by
    the level's maximum, which a delta can move; the JAX package's
    targeted refresh leaves those entries too.)"""
    root = tmp_path / "s"
    live = {}
    checks = []
    real = tdelta.refresh_serving

    def paths(store):
        out = []
        for name in ("default", "user-1|alltime"):
            layer = store.layer(name)
            if layer is None:
                continue
            for d in layer.detail_zooms:
                z = d - layer.result_delta
                codes = np.unique(np.asarray(layer.levels[d].codes)
                                  >> (2 * layer.result_delta))[:6]
                for code in codes.tolist():
                    x = y = 0
                    for bit in range(z):
                        x |= ((code >> (2 * bit)) & 1) << bit
                        y |= ((code >> (2 * bit + 1)) & 1) << bit
                    for fmt in ("png", "json"):
                        out.append(f"/tiles/{name.replace('|', '%7C')}/"
                                   f"{z}/{x}/{y}.{fmt}")
        return out

    def on_serve(app, base_url):
        live["app"], live["base"] = app, base_url

    def refresh(result, store, cache=None):
        base = live["base"]
        if not live.get("filled"):
            for p in paths(store):
                _get(base + p)
            live["filled"] = True
        cached = set(cache._entries)
        n = real(result, store, cache)
        want = sum(1 for k in cached if k in set(result.affected_keys))
        cold = TApp(TStore(f"delta:{root}"), TCache())
        keys = result.affected_keys
        touched = []
        for p in paths(store):
            _, _, name, z, x, y = p.split("/")
            y, fmt = y.split(".")
            key = (name.replace("%7C", "|"), int(z), int(x), int(y), fmt)
            if key in keys or fmt == "json":
                touched.append(p)
        for p in touched:
            status, etag, body = _get(base + p)
            c = cold.handle("GET", p)
            assert (status, body, etag) == (c[0], c[2], c[3]), p
        checks.append((n, want, len(touched)))
        return n

    monkeypatch.setattr(tdelta, "refresh_serving", refresh)
    args = tcli.build_parser().parse_args(
        _ingest_argv(root, "--queue-depth", "0"))
    summary, stats = tcli.run_ingest_command(args, on_serve=on_serve)
    assert len(checks) == summary["epochs"] == 5
    assert all(n == want for n, want, _ in checks)
    assert summary["keys_invalidated"] == sum(n for n, _, _ in checks) > 0
    assert stats.keys_invalidated == summary["keys_invalidated"]


def _serve_argv(store, *extra):
    return ["serve", "--store", store, "--port", "0", *extra]


def test_serve_command_answers_as_jax(levels, capsys, monkeypatch):
    """``start_serve`` binds the JAX ``serve``'s server: the banner's
    JAX keys then ``device`` (None: no device work), the same bytes
    over HTTP, and no CUDA call on the way."""
    import torch

    def no_cuda(*a, **k):
        raise AssertionError("serve touched torch.cuda")

    for name in ("init", "is_available", "device_count", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    spec = f"arrays:{levels}/arrays"
    handle = tcli.start_serve(tcli.build_parser().parse_args(
        _serve_argv(spec, "--cache-bytes", "1000000", "--layers",
                    "all=all|alltime,m=user-1")))
    import threading

    thread = threading.Thread(target=handle.server.serve_forever,
                              daemon=True)
    thread.start()
    try:
        banner = handle.banner
        assert list(banner) == ["serving", "store", "layers", "cache_bytes",
                                "ttl_s", "device"]
        assert banner["layers"] == ["all", "m"] and banner["device"] is None
        japp = JApp(JStore(spec, layers={"all": "all|alltime",
                                         "m": "user-1"}),
                    JCache(max_bytes=1000000))
        layer = japp.store.layer("all")
        d = layer.detail_zooms[-1]
        z = d - layer.result_delta
        code = int(np.asarray(layer.levels[d].codes)[0]) >> (
            2 * layer.result_delta)
        x = y = 0
        for bit in range(z):
            x |= ((code >> (2 * bit)) & 1) << bit
            y |= ((code >> (2 * bit + 1)) & 1) << bit
        for path in (f"/tiles/all/{z}/{x}/{y}.png",
                     f"/tiles/all/{z}/{x}/{y}.json",
                     f"/tiles/m/{z}/{x}/{y}.json", "/tiles/all/0/5/0.png",
                     "/nothing"):
            status, etag, body = _get(banner["serving"] + path)
            want = japp.handle("GET", path)
            assert (status, etag, body) == (want[0], want[3], want[2])
    finally:
        handle.server.shutdown()
        handle.close()
        thread.join(5)


def test_serve_follow_stream_builds_the_jax_live_layer(tmp_path):
    """``serve --follow-stream`` on the CPU: the pump's live layer after
    the whole source equals a JAX LiveLayer fed the same batches, and
    the live tiles answer with its bytes."""
    from heatmap_tpu.io import open_source as jopen_source
    from heatmap_tpu.ops import window_from_bounds as jwindow
    from heatmap_tpu.pipeline import load_columns as jload_columns
    from heatmap_tpu.serve import LiveLayer as JLive
    from heatmap_tpu.streaming import HeatmapStream as JStream
    from heatmap_tpu.streaming import StreamConfig as JConfig

    store = tmp_path / "lv"
    assert tcli.main(["run", "--input", "synthetic:200:1", "--backend",
                      "cpu", "--detail-zoom", "10",
                      "--output", f"arrays:{store}"]) == 0
    follow = "synthetic:20000:8"
    flags = ["--follow-stream", follow, "--tick-seconds", "0",
             "--batch-points", "4096", "--zoom", "10", "--backend", "cpu"]
    handle = tcli.start_serve(tcli.build_parser().parse_args(
        _serve_argv(f"arrays:{store}", *flags)))
    try:
        handle.live.thread.join(60)
        assert not handle.live.thread.is_alive()
        assert handle.device == "cpu" and handle.banner["device"] == "cpu"
        assert handle.live.ticks == 5
        assert handle.app.cache.ttl_s == 30.0  # interval / 2
        import jax.numpy as jnp

        jl = JLive(JStream(JConfig(
            window=jwindow((45.0, 50.0), (-125.0, -119.0), zoom=10),
            half_life_s=3600.0, proj_dtype=jnp.float64, pad_to=4096)),
            name="live")
        t = 0.0
        for batch in jopen_source(follow, read_value=False).batches(4096):
            cols = jload_columns(batch)
            t += 60.0
            jl.tick(cols["latitude"], cols["longitude"], t)
        tl = handle.live.layer
        assert tl.levels.keys() == jl.levels.keys()
        for z in jl.levels:
            np.testing.assert_array_equal(tl.levels[z].codes,
                                          jl.levels[z].codes)
            np.testing.assert_array_equal(tl.levels[z].values,
                                          jl.levels[z].values)
        japp = JApp(JStore(f"arrays:{store}"), JCache())
        japp.attach_layer("live", jl)
        code = int(jl.levels[10].codes[0]) >> 10
        x = y = 0
        for bit in range(5):
            x |= ((code >> (2 * bit)) & 1) << bit
            y |= ((code >> (2 * bit + 1)) & 1) << bit
        for fmt in ("png", "json"):
            path = f"/tiles/live/5/{x}/{y}.{fmt}"
            a, b = japp.handle("GET", path), handle.app.handle("GET", path)
            assert (a[0], a[2], a[3]) == (b[0], b[2], b[3])
    finally:
        handle.close()


@pytest.mark.parametrize("argv", [
    ["writeplane"], ["writeplane", "--journal", "j", "--planes", "2"]])
def test_writeplane_argv_exits_2_as_jax(capsys, argv):
    """A missing ``--root`` or an unknown flag: both parsers exit 2 with
    the same complaint."""
    errs = []
    for main in (tcli.main, jcli.main):
        with pytest.raises(SystemExit) as err:
            main(argv)
        assert err.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0].split(": ", 1)[1] == errs[1].split(": ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["serve", "--store", "x", "--fleet", "2"],
    ["serve", "--store", "x", "--max-inflight", "8"],
    ["serve", "--store", "x", "--queue-deadline", "0.5"],
    ["serve", "--store", "x", "--hedge-quantile", "0.9"],
    ["serve", "--store", "x", "--probe-interval", "2"]])
def test_fleet_flags_parse_as_jax(argv):
    """``serve --fleet`` and the router's flags parse to the JAX
    parser's values (and defaults)."""
    got = vars(tcli.build_parser().parse_args(argv))
    want = vars(jcli.build_parser().parse_args(argv))
    for k in ("fleet", "max_inflight", "queue_deadline", "hedge_quantile",
              "probe_interval"):
        assert got[k] == want[k], k


def test_serve_flags_match_jax():
    """Every flag of the JAX ``serve`` (and ``render``, ``ingest``,
    ``writeplane``) parses in the port."""
    jp = jcli.build_parser()
    tp = tcli.build_parser()

    def flags(ap, cmd):
        sub = next(a for a in ap._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {o for a in sub.choices[cmd]._actions
                for o in a.option_strings}

    for cmd in ("serve", "render", "ingest", "writeplane"):
        missing = flags(jp, cmd) - flags(tp, cmd)
        assert not missing, (cmd, missing)
