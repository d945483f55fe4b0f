"""CLI parity of the write plane and the serve fleet on the CPU:
``python -m heatmap_tpu_torch writeplane --device cpu`` against
``python -m heatmap_tpu writeplane --backend cpu`` on the same input (the
same summary keys and values, seconds and lags aside, then ``device``;
the same served levels and plane files), the same refusals, and ``serve
--fleet 2`` over the write plane's root as a real command: its banner,
tiles equal to the single-process JAX app's, and its children gone after
an interrupt."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from heatmap_tpu import cli as jcli
from heatmap_tpu.serve import ServeApp as JApp
from heatmap_tpu.serve import TileCache as JCache
from heatmap_tpu.serve import TileStore as JStore
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import obs as tobs
from heatmap_tpu_torch.delta import recover as trecover
from heatmap_tpu_torch.serve import TileStore as TStore
from heatmap_tpu_torch.tilemath.morton import morton_decode_np
from heatmap_tpu_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    yield
    trecover.clear_verified_cache()
    tobs.enable_metrics(False)
    tobs.get_registry().reset()


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _plane_files(root):
    """The files of a plane root that a drain determines: the range
    stores (journal entries as their meta without the wall-clock
    ``ts``), the pointed manifest but its epoch, and the ledger's
    batches. An earlier manifest records whichever sub-applies had
    landed when a batch finished, and ledger epochs follow the batches'
    completion order: both vary with the pumps' timing, in either
    package."""
    out, ledger = {}, set()
    with open(os.path.join(root, "MANIFEST")) as f:
        pointed = "manifest-%06d.json" % json.load(f)["epoch"]
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f == "MANIFEST" or f.startswith("manifest-"):
                if f == pointed:
                    # Its epoch counts the flips (timing; see below).
                    with open(path) as fh:
                        snap = json.load(fh)
                    out["manifest"] = {k: v for k, v in snap.items()
                                       if k not in ("epoch", "digest")}
                continue
            if f.startswith("ckpt-"):
                meta = load_checkpoint(path)[1]
                meta.pop("ts", None)
                if rel.startswith("ledger" + os.sep):
                    ledger.add((meta["content_hash"], meta["points"],
                                meta["sign"]))
                    continue
                out[rel] = json.dumps(meta, sort_keys=True)
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    out["ledger"] = sorted(ledger)
    return out


def _levels(store):
    return {(name, z): (np.asarray(lv.codes).tolist(),
                        np.asarray(lv.values).tolist())
            for name, layer in store.layers.items()
            for z, lv in layer.levels.items()}


ARGVS = {
    "defaults": ["--input", "synthetic:3000:7"],
    "retract_rebalance": ["--input", "synthetic:3000:7", "--retractions",
                          "synthetic:1000:7", "--rebalance", "--writers",
                          "4"],
    "exact_timespans": ["--input", "synthetic:2000:5", "--pad-bucketing",
                        "exact", "--timespans", "alltime,month",
                        "--writers", "1"],
    "weighted_csv": ["--input", "csv:{csv}", "--weighted", "--writers",
                     "3"],
    "one_batch_queue1": ["--input", "synthetic:2500:3", "--queue-depth", "1",
                         "--publish-every", "2", "--max-ticks", "2"],
}


def _valued_csv(path, n=2500, seed=9):
    """Clustered points with integer ``value`` weights, as a CSV."""
    rng = np.random.default_rng(seed)
    lat = 47.6 + rng.normal(0, 0.3, n)
    lon = -122.3 + rng.normal(0, 0.4, n)
    with open(path, "w") as f:
        f.write("latitude,longitude,user_id,source,timestamp,value\n")
        for i in range(n):
            f.write(f"{float(lat[i])!r},{float(lon[i])!r},user-{i % 5},gps,"
                    f"{1500000000000 + 1000 * i},{i % 7}\n")
    return path


@pytest.mark.parametrize("case", list(ARGVS))
def test_writeplane_command_equals_jax(tmp_path, capsys, case):
    csv = _valued_csv(tmp_path / "points.csv") if case == "weighted_csv" \
        else None
    common = ["--detail-zoom", "10", "--micro-batch", "1000",
              *(a.format(csv=csv) for a in ARGVS[case])]
    troot, jroot = str(tmp_path / "t"), str(tmp_path / "j")
    assert tcli.main(["writeplane", "--root", troot, "--device", "cpu",
                      *common]) == 0
    got = _last_json(capsys.readouterr().out)
    assert jcli.main(["writeplane", "--root", jroot, "--backend", "cpu",
                      *common]) == 0
    want = _last_json(capsys.readouterr().out)
    assert list(got) == [*want, "device"] and got["device"] == "cpu"
    # Two batches finishing on two pump threads at once can share one
    # manifest flip, in either package: the publishes (and so the
    # epoch) follow the pumps' timing, the rest is exact.
    timing = ("lag_p50_s", "publishes")
    for k in want:
        if k in ("root", "seconds", "epoch"):
            continue
        if k == "runs":
            for g, w in zip(got[k], want[k], strict=True):
                assert g["failed"] == 0 and g["completed"] == g["batches"]
                assert {a: b for a, b in g.items() if a not in timing} \
                    == {a: b for a, b in w.items() if a not in timing}
                assert (g["lag_p50_s"] is None) == (w["lag_p50_s"] is None)
                every = int(dict(zip(common, common[1:])).get(
                    "--publish-every", 1))
                assert 1 <= g["publishes"] <= -(-g["batches"] // every)
            continue
        assert got[k] == want[k], k
    for out in (got, want):
        # The plan's epoch, one per publish, and the final one.
        assert out["epoch"] == 2 + sum(r["publishes"]
                                       for r in out.get("runs", [])) + (
            1 if (out.get("rebalance") or None) else 0)
    assert _levels(TStore(f"writeplane:{troot}")) == _levels(
        JStore(f"writeplane:{jroot}"))
    assert _plane_files(troot) == _plane_files(jroot)


def test_writeplane_telemetry_matches_jax(tmp_path, capsys):
    """--events and --metrics-dir: the same write-plane events, and the
    write plane's series in metrics.prom."""
    common = ["--detail-zoom", "10", "--micro-batch", "1000", "--input",
              "synthetic:2000:7"]
    kinds = {}
    for name, main, flag in (("t", tcli.main, ["--device", "cpu"]),
                             ("j", jcli.main, ["--backend", "cpu"])):
        d = tmp_path / name
        assert main(["writeplane", "--root", str(d / "root"), *flag,
                     *common, "--events", str(d / "ev.jsonl"),
                     "--metrics-dir", str(d)]) == 0
        capsys.readouterr()
        with open(d / "ev.jsonl") as f:
            recs = [json.loads(line) for line in f]
        # The write plane's own events and the delta applies under them
        # (the cascade's internal events differ between the packages).
        kinds[name] = sorted(
            r["event"] for r in recs if r["event"].startswith("writeplane")
            or r["event"] in ("run_start", "run_end", "partition_planned",
                              "delta_applied"))
        prom = (d / "metrics.prom").read_text()
        assert "writeplane_publishes_total" in prom
        assert "writeplane_points_total" in prom
    assert kinds["t"] == kinds["j"]
    assert "partition_planned" in kinds["t"]


@pytest.mark.parametrize("flags", [
    ["--timespans", "alltime,decade"], ["--retention", "1"],
    ["--writers", "0"]])
def test_writeplane_refusals_match_jax(tmp_path, flags):
    msgs = []
    for main, dev in ((tcli.main, ["--device", "cpu"]),
                      (jcli.main, ["--backend", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(["writeplane", "--root", str(tmp_path / "r"), *dev,
                  "--input", "synthetic:10", *flags])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("flag,value", [("--data-parallel", "on"),
                                        ("--dispatch", "gspmd")])
def test_writeplane_mesh_flags_refused_as_run(capsys, flag, value):
    with pytest.raises(SystemExit) as exc:
        tcli.build_parser().parse_args(
            ["writeplane", "--root", "R", flag, value])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "item 7" in err


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.headers.get("ETag"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("ETag"), e.read()


def _children(pid):
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                out.append(int(entry))
    return out


def test_serve_fleet_command_over_a_plane_root(tmp_path, capsys):
    """``serve --store writeplane:ROOT --fleet 2 --port 0`` as a process:
    the banner names two backends, tiles equal the single-process JAX
    app's, and an interrupt stops the router and both children."""
    root = str(tmp_path / "plane")
    assert tcli.main(["writeplane", "--root", root, "--device", "cpu",
                      "--input", "synthetic:3000:7", "--detail-zoom", "10",
                      "--micro-batch", "1000"]) == 0
    capsys.readouterr()
    spec = f"writeplane:{root}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "heatmap_tpu_torch", "serve", "--store", spec,
         "--fleet", "2", "--port", "0", "--probe-interval", "0.2"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    try:
        banner = json.loads(proc.stderr.readline())
        assert list(banner) == ["serving", "store", "fleet", "device"]
        assert sorted(banner["fleet"]) == ["b0", "b1"]
        children = _children(proc.pid)
        assert len(children) == 2
        base = banner["serving"]
        japp = JApp(JStore(spec), JCache())
        layer = japp.store.layer("default")
        d = layer.detail_zooms[-1]
        codes = np.unique(np.asarray(layer.levels[d].codes)
                          >> (2 * layer.result_delta))[:5]
        rows, cols = morton_decode_np(codes)
        z = d - layer.result_delta
        for r, c in zip(rows, cols):
            for fmt in ("png", "json"):
                path = f"/tiles/default/{z}/{int(c)}/{int(r)}.{fmt}"
                want = japp.handle("GET", path)
                assert _get(base + path) == (want[0], want[3], want[2])
        health = json.loads(_get(base + "/healthz")[2])
        assert health["fleet"]["size"] == 2
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(30)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            os.path.exists(f"/proc/{c}") for c in children):
        time.sleep(0.05)
    assert not any(os.path.exists(f"/proc/{c}") for c in children)
