"""``heatmap_tpu_torch.tools.load_gen`` on the CPU against
``tools/load_gen.py`` over one small store: the same tile universe, the
same closed-loop and brownout record keys; the hidden ``--drive`` client
process with every ``torch.cuda`` entry point trapped; ``--cold-vs-warm``
merged into an existing record (its fleet probe stubbed: no test here
spawns a fleet)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from test_torch_tools import _jax_tool, _reset  # noqa: F401

from heatmap_tpu_torch.tools import load_gen

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def levels(tmp_path_factory):
    """A small ``arrays-tilefs:`` store (npz levels and tilefs mirrors)."""
    from heatmap_tpu_torch.io import open_sink, open_source
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job

    path = tmp_path_factory.mktemp("loadgen") / "levels"
    with open_sink(f"arrays-tilefs:{path}") as sink:
        run_job(open_source("synthetic:4000:6"), sink,
                BatchJobConfig(detail_zoom=10, min_detail_zoom=6,
                               result_delta=2), device="cpu")
    return str(path)


def test_tile_universe_equals_jax(levels):
    from heatmap_tpu.serve import TileStore as JTileStore
    from heatmap_tpu_torch.serve import TileStore

    jtool = _jax_tool("load_gen")
    got = load_gen.tile_universe(TileStore(f"arrays:{levels}"), 60, seed=3)
    want = jtool.tile_universe(JTileStore(f"arrays:{levels}"), 60, seed=3)
    assert got and got == want


@pytest.mark.parametrize("mode", ["serve", "adaptive"])
def test_load_gen_twin_record_equals_jax_tool(levels, tmp_path, monkeypatch,
                                              mode):
    argv = ["--store", f"arrays:{levels}", "--workers", "2", "--duration",
            "0.3", "--tiles", "20"]
    flag = "--out"
    if mode == "adaptive":
        argv += ["--adaptive", "--adaptive-stage-s", "0.15"]
        flag = "--adaptive-out"
    assert load_gen.main([*argv, "--device", "cpu", flag,
                          str(tmp_path / "t.json")]) == 0
    jtool = _jax_tool("load_gen")
    monkeypatch.setattr(sys, "argv", ["load_gen.py", *argv, flag,
                                      str(tmp_path / "j.json")])
    assert jtool.main() == 0
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert list(got) == [*list(want), "device"] and got["device"] == "host"
    if mode == "serve":
        assert list(want) == list(load_gen.RECORD_KEYS)
        for key in ("bench", "store", "workers", "tiles"):
            assert got[key] == want[key], key
        assert got["errors"] == 0 and got["requests"] > 0
        assert list(got["obs"]) == list(want["obs"])
        assert list(got["latency_ms"]) == list(want["latency_ms"])
    else:
        for key in ("bench", "store", "stages", "max_inflight"):
            assert got[key] == want[key], key
        assert list(got["legs"]) == list(want["legs"]) == ["off", "on"]
        for leg in ("off", "on"):
            assert list(got["legs"][leg]) == list(want["legs"][leg])


def test_drive_clients_and_cuda_free_driver(levels, tmp_path):
    from heatmap_tpu_torch.serve import (ServeApp, TileCache, TileStore,
                                         serve_in_thread)

    store = TileStore(f"arrays:{levels}")
    universe = load_gen.tile_universe(store, 12)
    server, base = serve_in_thread(ServeApp(store, TileCache()))
    try:
        lat, statuses, errors = load_gen._drive_clients(
            base, universe, 0.3, workers=1, procs=1, tmpdir=str(tmp_path))
        assert len(lat) > 0 and errors == 0
        assert set(statuses) == {"200"}
        script = f"""
import sys
import torch
calls = []
for name in ("init", "is_available", "device_count", "current_device",
             "synchronize", "set_device", "get_device_name"):
    def trap(*a, _n=name, **k):
        calls.append(_n)
        raise RuntimeError("cuda touched: " + _n)
    setattr(torch.cuda, name, trap)
from heatmap_tpu_torch.tools import load_gen
rc = load_gen.main(["--drive", {base!r}, "--universe-file",
                    {str(tmp_path / "universe.json")!r}, "--duration",
                    "0.2", "--workers", "1"])
assert rc == 0 and not calls, calls
assert not torch.cuda.is_initialized()
assert "jax" not in sys.modules and "heatmap_tpu" not in sys.modules
"""
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert list(line) == ["latencies_ms", "statuses", "errors"]
        assert line["errors"] == 0 and line["latencies_ms"]
    finally:
        server.shutdown()
        server.server_close()


def test_cold_vs_warm_merges_into_record(levels, tmp_path, monkeypatch):
    from heatmap_tpu_torch.tools import mem_probe

    legs = []

    def stub(spec, n, paths, **kw):
        legs.append((spec, n, len(paths)))
        return {"spec": spec, "n": n, "paths": len(paths),
                "total_mb": 10.0, "per_backend_mb": [10.0] * n,
                "source": "pss"}

    monkeypatch.setattr(mem_probe, "measure_fleet_pss", stub)
    out = tmp_path / "serve.json"
    out.write_text(json.dumps({"bench": "serve", "rps": 1.0}))
    assert load_gen.main(["--store", f"arrays:{levels}", "--cold-vs-warm",
                          "--tiles", "16", "--rss-backends", "2",
                          "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert list(doc) == ["bench", "rps", "cold_warm", "fleet_rss", "device"]
    assert doc["device"] == "host"
    assert list(doc["cold_warm"]) == ["store", "tiles", "hot_tiles", "cold",
                                      "warmed", "speedup_p99"]
    assert doc["cold_warm"]["store"] == f"tilefs:{levels}"
    assert list(doc["fleet_rss"]) == ["n", "mapped", "heap", "pss_ratio",
                                      "source"]
    assert doc["fleet_rss"]["pss_ratio"] == 1.0
    assert legs == [(f"tilefs:{levels}", 2, 16), (f"arrays:{levels}", 2, 16)]
