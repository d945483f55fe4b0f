"""Peak memory of the bounded path's cross-chunk merge, and of a serve
fleet.

The port's twin of ``tools/mem_probe.py``. It writes the adversarial
shape (normal sigma ~0.5 deg around one city: near-unique z21 keys, so
the output is about the size of the input) as an HMPB file, then runs
``run_job_fast(..., max_points_in_flight=chunk)`` into ``arrays:``
egress once per mode, each in a fresh subprocess so one mode's
high-water marks cannot reach another's:

- ``ram``: the in-RAM merge (``batch.AUTO_SPILL_ROWS`` lifted, so the
  auto spill cannot take over);
- ``spill``: the disk-spill merge (``merge_spill_dir``).

Each mode prints one JSON line with the JAX tool's keys, ``{"peak_rss_gb",
"seconds", "rows", "mode", "wall_s", "n", "chunks"}``; on a card the
child also reads ``peak_device_bytes``, ``torch.cuda.max_memory_allocated()``
after the job (peak statistics reset before it). A chunk of at least
``--n`` still takes the bounded path (one chunk, its feeder buffers);
``run_mode`` with ``chunk=0`` runs the job single-shot, the route
``_auto_points_in_flight`` keeps for a source that fits. The lines also
go to the record file with ``device`` and, on a card, ``gpu_name`` and
``power_limit_w``.

``--fleet-rss SPEC`` instead spawns ``--fleet-n`` real fleet backend
processes over the store (host work only: they open no CUDA context),
sweeps the tile universe against each so the store's pages fault in,
and sums their Pss from ``/proc/<pid>/smaps_rollup`` (Pss divides
shared pages among their mappers, which is the point of an mmap'd
``tilefs:`` store). ``--fleet-rss-heap SPEC`` adds the heap leg and the
mapped/heap ratio; that record's ``device`` is ``host``.

    python -m heatmap_tpu_torch.tools.mem_probe [--n 20000000]
        [--chunk 2000000] [--modes ram,spill] [--device cuda|cpu]
        [--out build/torch_bench/mem_probe.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from heatmap_tpu_torch.tools._common import (HOST_FIELDS, default_out,
                                             device_fields, write_record)

#: The keys of one mode's line, in the JAX tool's order (the card's
#: ``peak_device_bytes`` follows ``rows``).
MODE_KEYS = ("peak_rss_gb", "seconds", "rows", "mode", "wall_s", "n",
             "chunks")

_CHILD = """
import json, resource, sys, time

import torch

from heatmap_tpu_torch.io.hmpb import HMPBSource
from heatmap_tpu_torch.io.sinks import LevelArraysSink
from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job_fast
from heatmap_tpu_torch.pipeline import batch as batch_mod

hmpb, out_dir, spill_dir, chunk, device = sys.argv[1:6]
chunk = int(chunk)
device = torch.device(device)
if spill_dir == "-":
    # "ram" measures the in-RAM fold alone: lift the auto spill.
    batch_mod.AUTO_SPILL_ROWS = 1 << 62
if device.type == "cuda":
    # An explicit index ("cuda:0") skips torch's lazy init, and the
    # allocator's statistics refuse a device it has not set up yet.
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(device)
t0 = time.perf_counter()
stats = run_job_fast(
    HMPBSource(hmpb), LevelArraysSink(out_dir), BatchJobConfig(),
    max_points_in_flight=chunk,
    merge_spill_dir=spill_dir if spill_dir != "-" else None,
    device=device,
)
if device.type == "cuda":
    torch.cuda.synchronize(device)
dt = time.perf_counter() - t0
peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
rec = {
    "peak_rss_gb": round(peak_kb / (1 << 20), 2),
    "seconds": round(dt, 1),
    "rows": stats.get("rows"),
}
if device.type == "cuda":
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
print(json.dumps(rec), flush=True)
"""


def _repo_root() -> str:
    import heatmap_tpu_torch

    return os.path.dirname(os.path.dirname(
        os.path.abspath(heatmap_tpu_torch.__file__)))


def build_points(path: str, n: int, seed: int = 3) -> None:
    from heatmap_tpu_torch.io.hmpb import write_hmpb

    rng = np.random.default_rng(seed)
    lat = rng.normal(47.6, 0.5, n)
    lon = rng.normal(-122.3, 0.5, n)
    routed = rng.integers(0, 8, n).astype(np.int32)
    write_hmpb(path, lat, lon, routed, [f"u{i}" for i in range(8)])


def run_mode(hmpb: str, mode: str, chunk: int, work: str, device) -> dict:
    out_dir = os.path.join(work, f"out-{mode}")
    spill = os.path.join(work, "spill") if mode == "spill" else "-"
    env = dict(os.environ)
    env["PYTHONPATH"] = _repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, hmpb, out_dir, spill, str(chunk),
         str(device)],
        capture_output=True, text=True, env=env,
    )
    if r.returncode != 0:
        raise SystemExit(f"{mode} child failed:\n{r.stderr[-2000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    rec.update(mode=mode, wall_s=round(time.perf_counter() - t0, 1))
    return rec


def pss_kb(pid: int) -> tuple:
    """``(kilobytes, source)`` of one process: Pss from smaps_rollup,
    else VmRSS, else ``(None, "unavailable")``."""
    try:
        with open(f"/proc/{pid}/smaps_rollup") as f:
            for line in f:
                if line.startswith("Pss:"):
                    return int(line.split()[1]), "pss"
    except OSError:
        pass
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]), "rss"
    except OSError:
        pass
    return None, "unavailable"


def measure_fleet_pss(spec: str, n: int, paths, *,
                      cache_bytes: int = 8 << 20) -> dict:
    """Total Pss of ``n`` real backend processes serving ``spec`` after
    each has answered every path in ``paths`` (each backend swept
    directly, not through the router, so all fault the same pages in;
    the heap cache kept small, so the store is what is measured)."""
    import http.client as http_client

    from heatmap_tpu_torch.serve.fleet import FleetSupervisor

    rows = []
    with FleetSupervisor(spec, n, cache_bytes=cache_bytes,
                         probe_interval_s=0.25) as sup:
        sup.start()
        for bid in sorted(sup.router.backends):
            client = sup.router.backends[bid]
            host, port = client.address.rsplit(":", 1)
            conn = http_client.HTTPConnection(host, int(port), timeout=30)
            for p in paths:
                conn.request("GET", p)
                conn.getresponse().read()
            conn.close()
        for bid in sorted(sup._handles):
            proc = getattr(sup._handles[bid], "proc", None)
            if proc is None:  # a thread-mode fleet: nothing to attribute
                continue
            kb, source = pss_kb(proc.pid)
            rows.append({"backend": bid, "pid": proc.pid,
                         "kb": kb, "source": source})
    measured = [r for r in rows if r["kb"] is not None]
    total_kb = sum(r["kb"] for r in measured)
    return {
        "spec": spec, "n": n, "paths": len(paths),
        "total_mb": round(total_kb / 1024, 1) if measured else None,
        "per_backend_mb": [round(r["kb"] / 1024, 1) for r in measured],
        "source": measured[0]["source"] if measured else "unavailable",
    }


def fleet_rss_mode(args) -> list:
    """``--fleet-rss``: the mapped (and optionally heap) fleet legs."""
    from heatmap_tpu_torch.serve import TileStore
    from heatmap_tpu_torch.tools.load_gen import tile_universe

    universe = tile_universe(TileStore(args.fleet_rss), args.fleet_tiles)
    paths = [f"/tiles/{layer}/{z}/{x}/{y}.{fmt}"
             for layer, z, x, y, fmt in universe]
    lines = []
    mapped = measure_fleet_pss(args.fleet_rss, args.fleet_n, paths)
    lines.append({"leg": "mapped", **mapped})
    print(json.dumps(lines[-1]), flush=True)
    if args.fleet_rss_heap:
        heap = measure_fleet_pss(args.fleet_rss_heap, args.fleet_n, paths)
        lines.append({"leg": "heap", **heap})
        print(json.dumps(lines[-1]), flush=True)
        ratio = (round(mapped["total_mb"] / heap["total_mb"], 4)
                 if mapped["total_mb"] and heap["total_mb"] else None)
        lines.append({"pss_ratio": ratio, "n": args.fleet_n})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="heatmap_tpu_torch.tools.mem_probe")
    ap.add_argument("--n", type=int, default=20_000_000)
    ap.add_argument("--chunk", type=int, default=2_000_000)
    ap.add_argument("--modes", default="ram,spill")
    ap.add_argument("--workdir", default=None,
                    help="default: a fresh temp dir (removed on exit)")
    ap.add_argument("--fleet-rss", default=None, metavar="SPEC",
                    help="serve-fleet Pss probe over this store spec "
                    "(e.g. tilefs:levels/) instead of the merge probe")
    ap.add_argument("--fleet-rss-heap", default=None, metavar="SPEC",
                    help="heap comparison leg (e.g. arrays:levels/); "
                    "with --fleet-rss, also prints the Pss ratio")
    ap.add_argument("--fleet-n", type=int, default=3,
                    help="backends per fleet leg")
    ap.add_argument("--fleet-tiles", type=int, default=128,
                    help="tile universe size swept per backend")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the merge probe's "
                    "jobs run (the fleet probe is host work)")
    ap.add_argument("--out", default=default_out("mem_probe"),
                    help="record file (default %(default)s)")
    args = ap.parse_args(argv)

    from heatmap_tpu_torch.devices import resolve_device

    if args.fleet_rss:
        lines = fleet_rss_mode(args)
        fields = HOST_FIELDS
    else:
        import shutil

        device = resolve_device(args.device)
        fields = device_fields(device)
        lines = []
        work = args.workdir or tempfile.mkdtemp(prefix="mem-probe-")
        try:
            hmpb = os.path.join(work, "pts.hmpb")
            build_points(hmpb, args.n)
            for mode in args.modes.split(","):
                rec = run_mode(hmpb, mode.strip(), args.chunk, work, device)
                rec.update(n=args.n, chunks=-(-args.n // args.chunk))
                print(json.dumps(rec), flush=True)
                lines.append(rec)
        finally:
            if args.workdir is None:
                shutil.rmtree(work, ignore_errors=True)
    write_record(args.out, {"results": lines, **fields})
    return 0


if __name__ == "__main__":
    sys.exit(main())
