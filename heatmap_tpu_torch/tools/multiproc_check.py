"""Real multi-process validation of the port's multihost layer (gloo).

The port's twin of ``tools/multiproc_check.py``. It spawns k children
that join one gloo process group through
``parallel.multihost.initialize`` (the JAX cluster variables' values:
coordinator address, process count, process id) and run the real code
paths end to end, each cascade on ``--device`` (on a card, every child
on the same card):

- process-sharded ingest (``shard_source_rows`` batch slices);
- ``egress="gather"``: the byte all-gather; every process's merged
  dict must equal a single-process ``run_job`` oracle (also weighted,
  bounded, bounded weighted, and with a data-parallel mesh per process
  under both merges);
- ``egress="sharded"``: the all-to-all byte exchange; each process's
  owned shard holds exactly its ``blob_owner`` keys (bounded too), and
  the per-host JSONL sink shards reassemble to the oracle;
- columnar sharded egress: ``scatter_levels`` and per-host
  ``LevelArraysSink`` dirs reassembling to the oracle's level arrays;
- the cross-process merge of the binning and reduce-by-key kernels.
  The port's meshes never span processes (``make_hybrid_mesh`` is the
  local mesh): each process bins or reduces its slice on its own mesh
  and the results merge through the byte all-gather, where the JAX tool
  psums over one mesh spanning both processes.

``--skew-only`` runs only the skewed byte exchange (one hot pair 100x
the rest; use ``--k 4`` for several shift rounds).

    python -m heatmap_tpu_torch.tools.multiproc_check [--k 2] [--n 3000]
        [--timeout 600] [--skew-only] [--device cuda|cpu]

Prints one JSON line per process, then the parent's verdict
``{"check": "multiproc", "ok": ..., "k", "n", "s", "launches", "device",
...}`` (``launches``: the kernels' launches summed over the children).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

_CHILD = r"""
import json, os, sys
import numpy as np
import torch

coord, pid, k, n, work, device = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
    sys.argv[5], sys.argv[6],
)
import torch.distributed as dist

from heatmap_tpu_torch.devices import resolve_device
from heatmap_tpu_torch.parallel import multihost as mh

device = resolve_device(device)
mh.initialize(coord, num_processes=k, process_id=pid)

from heatmap_tpu_torch.io.sinks import (
    JSONLBlobSink, LevelArraysSink, open_sink, per_process_sink_spec,
)
from heatmap_tpu_torch.io.sources import SyntheticSource
from heatmap_tpu_torch.ops import pallas_kernels as pk
from heatmap_tpu_torch.ops import partitioned as pt
from heatmap_tpu_torch.ops import sparse_partitioned as sp
from heatmap_tpu_torch.parallel.multihost import (
    _all_gather_bytes, blob_owner, run_job_multihost,
)
from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job


def blobs_equal(got, want):
    # Decoded equality: re-encoded collision merges may reorder the
    # inner dicts, so string equality is too strict.
    return set(got) == set(want) and all(
        json.loads(got[key]) == json.loads(want[key]) for key in want
    )


cfg = BatchJobConfig(detail_zoom=11, min_detail_zoom=8)
src = SyntheticSource(n=n, seed=13)
batch = 256
checks = {}

# Oracle: the plain single-process job over the whole source.
want = run_job(SyntheticSource(n=n, seed=13), config=cfg,
               batch_size=batch, max_points_in_flight=0, device=device)

# 1) gather egress over the byte all-gather.
got = run_job_multihost(src, config=cfg, batch_size=batch,
                        egress="gather", device=device)
checks["gather_equals_oracle"] = blobs_equal(got, want)


# 1b) a weighted job over the same transport: integer-valued f64
# weights from the GLOBAL row position sum exactly under any split.
class _WSrc:
    n = n

    def batches(self, batch_size):
        off = 0
        for b in SyntheticSource(n=n, seed=13).batches(batch_size):
            m = len(b["latitude"])
            b = dict(b)
            b["value"] = ((np.arange(off, off + m) % 7) + 1).astype(
                np.float64
            )
            off += m
            yield b


wcfg = BatchJobConfig(detail_zoom=11, min_detail_zoom=8, weighted=True)
want_w = run_job(_WSrc(), config=wcfg, batch_size=batch,
                 max_points_in_flight=0, device=device)
got_w = run_job_multihost(_WSrc(), config=wcfg, batch_size=batch,
                          egress="gather", device=device)
checks["weighted_gather_equals_oracle"] = blobs_equal(got_w, want_w)

# 1c) each slice through the chunked cascade and host merge.
got_b = run_job_multihost(src, config=cfg, batch_size=batch,
                          egress="gather", max_points_in_flight=700,
                          device=device)
checks["bounded_gather_equals_oracle"] = blobs_equal(got_b, want)

# 1d) bounded + weighted, and bounded + sharded egress (this process's
# shard holds exactly the oracle keys it owns).
got_wb = run_job_multihost(_WSrc(), config=wcfg, batch_size=batch,
                           egress="gather", max_points_in_flight=700,
                           device=device)
checks["bounded_weighted_equals_oracle"] = blobs_equal(got_wb, want_w)
owned_b = run_job_multihost(src, config=cfg, batch_size=batch,
                            egress="sharded", max_points_in_flight=700,
                            device=device)
expected_owned = {key for key in want if blob_owner(key, k) == pid}
checks["bounded_sharded_owned_ok"] = (
    set(owned_b) == expected_owned
    and all(json.loads(owned_b[key]) == json.loads(want[key])
            for key in owned_b)
)

# 1e) a data-parallel mesh inside each process, then the gather.
dp_cfg = BatchJobConfig(detail_zoom=11, min_detail_zoom=8,
                        data_parallel=True)
got_dp = run_job_multihost(src, config=dp_cfg, batch_size=batch,
                           egress="gather", device=device)
checks["dp_gather_equals_oracle"] = blobs_equal(got_dp, want)

# 1f) the same with the coarse-prefix merge.
pfx_cfg = BatchJobConfig(detail_zoom=11, min_detail_zoom=8,
                         data_parallel=True, dp_merge="prefix")
got_pfx = run_job_multihost(src, config=pfx_cfg, batch_size=batch,
                            egress="gather", device=device)
checks["dp_prefix_gather_equals_oracle"] = blobs_equal(got_pfx, want)

# 2) sharded blob egress over the all-to-all; per-host JSONL through
# the CLI's own spec parser.
with open_sink(per_process_sink_spec(f"jsonl:{work}/blobs.jsonl",
                                     pid)) as sink:
    owned = run_job_multihost(src, sink, cfg, batch_size=batch,
                              egress="sharded", device=device)
checks["owned_keys_are_mine"] = all(
    blob_owner(key, k) == pid for key in owned
)
dist.barrier()
if pid == 0:
    merged = {}
    for i in range(k):
        merged.update(JSONLBlobSink.load(f"{work}/blobs.jsonl.p{i:03d}"))
    checks["sharded_union_equals_oracle"] = (
        set(merged) == set(want)
        and all(merged[key] == json.loads(want[key]) for key in want)
    )

# 3) columnar sharded egress: per-host level-array dirs.
stats = run_job_multihost(
    src, open_sink(per_process_sink_spec(f"arrays:{work}/cols", pid)),
    cfg, batch_size=batch, egress="sharded", device=device,
)
checks["columnar_stats"] = stats.get("egress") == "levels-sharded"
dist.barrier()
if pid == 0:
    ref_dir = os.path.join(work, "oracle-cols")
    run_job(SyntheticSource(n=n, seed=13), LevelArraysSink(ref_dir),
            config=cfg, batch_size=batch, max_points_in_flight=0,
            device=device)
    want_cols = LevelArraysSink.load(ref_dir)
    per_host = [LevelArraysSink.load(f"{work}/cols/host{i:03d}")
                for i in range(k)]
    got_zooms = set().union(*(set(h) for h in per_host))
    ok = got_zooms == set(want_cols)
    for zoom, wlvl in want_cols.items():
        if not ok:
            break
        rows = {c: [] for c in ("row", "col", "value", "user", "timespan")}
        for got_cols in per_host:
            if zoom in got_cols:
                for c in rows:
                    rows[c].append(got_cols[zoom][c])
        if not rows["value"]:
            ok = False
            break
        cat = {c: np.concatenate(rows[c]) for c in rows}
        if len(cat["value"]) != len(wlvl["value"]):
            ok = False
            break
        order_g = np.lexsort((cat["col"], cat["row"], cat["user"],
                              cat["timespan"]))
        order_w = np.lexsort((wlvl["col"], wlvl["row"], wlvl["user"],
                              wlvl["timespan"]))
        for c in rows:
            if not np.array_equal(np.asarray(cat[c])[order_g],
                                  np.asarray(wlvl[c])[order_w]):
                ok = False
        if not ok:
            break
    checks["columnar_union_equals_oracle"] = ok

# 4) the kernels' results merged across processes: each process bins
# (reduces) its slice on its own mesh, the byte all-gather merges.
from heatmap_tpu_torch.ops import (
    aggregate_keys, bin_points_window, window_from_bounds,
)
from heatmap_tpu_torch.parallel import (
    aggregate_keys_sharded, bin_points_replicated, bin_points_rowsharded,
)
from heatmap_tpu_torch.parallel.multihost import make_hybrid_mesh

mesh = make_hybrid_mesh(devices=[device])
ndev = len(mesh.flat)
rng = np.random.default_rng(17)
n_pts = ndev * k * (4096 // (ndev * k))
lats = rng.uniform(35.0, 55.0, n_pts)
lons = rng.uniform(-5.0, 20.0, n_pts)
win = window_from_bounds((35.0, 55.0), (-5.0, 20.0), zoom=9,
                         align_levels=0, pad_multiple=ndev * k)
lo, hi = pid * (n_pts // k), (pid + 1) * (n_pts // k)


def on(x):
    return torch.as_tensor(x, device=device)


def merged_sum(t):
    parts = _all_gather_bytes(t.cpu().numpy().tobytes())
    arrs = [np.frombuffer(p, dtype=t.cpu().numpy().dtype) for p in parts]
    return sum(a.astype(np.int64) for a in arrs).reshape(tuple(t.shape))


local_raster = bin_points_window(on(lats), on(lons), win).cpu().numpy()
raster = bin_points_replicated(on(lats[lo:hi]), on(lons[lo:hi]), win, mesh)
checks["crossproc_psum_binning"] = bool(
    (merged_sum(raster) == local_raster).all())
rowsharded = bin_points_rowsharded(on(lats[lo:hi]), on(lons[lo:hi]), win,
                                   mesh)
checks["crossproc_psum_scatter_binning"] = bool(
    (merged_sum(rowsharded) == local_raster).all())

keys = rng.integers(0, 500, n_pts).astype(np.int32)
gu, gs, gn = aggregate_keys_sharded(on(keys[lo:hi]), mesh, capacity=512)
m = int(gn)
parts = _all_gather_bytes(json.dumps(
    [gu[:m].cpu().tolist(), gs[:m].cpu().tolist()]).encode())
cat_u = np.concatenate([np.asarray(json.loads(p)[0], np.int32)
                        for p in parts])
cat_s = np.concatenate([np.asarray(json.loads(p)[1], np.int64)
                        for p in parts])
mu, ms, mn = aggregate_keys(on(cat_u), weights=on(cat_s), capacity=512)
lu, ls, ln = aggregate_keys(on(keys), capacity=512)
checks["crossproc_aggregate_keys"] = (
    int(mn) == int(ln)
    and bool((mu[:int(mn)].cpu() == lu[:int(ln)].cpu()).all())
    and bool((ms[:int(mn)].cpu().to(torch.int64)
              == ls[:int(ln)].cpu().to(torch.int64)).all())
)

dist.barrier()
launches = {
    "segment_reduce": sp.aggregate_sorted_keys_partitioned.launches,
    "window_histogram": pk.bin_rowcol_window_pallas.launches,
    "window_partitioned": pt.bin_rowcol_window_partitioned.launches,
    "window_partitioned_weighted":
        pt.bin_rowcol_window_partitioned.weighted_launches,
}
print(json.dumps({"pid": pid, "ok": all(checks.values()),
                  "checks": checks, "launches": launches,
                  "mesh": "per process (merged by the byte all-gather)"}),
      flush=True)
sys.exit(0 if all(checks.values()) else 1)
"""


_SKEW_CHILD = r"""
import json, sys
import numpy as np

coord, pid, k = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
from heatmap_tpu_torch.parallel import multihost as mh

mh.initialize(coord, num_processes=k, process_id=pid)

from heatmap_tpu_torch.parallel.multihost import _alltoall_bytes


def payload(src, dst):
    # ONE hot pair (1 -> 0) 100x the rest.
    n = 200_000 if (src, dst) == (1, 0) else 2_000
    rng = np.random.default_rng(1000 * src + dst)
    return rng.integers(0, 256, n).astype(np.uint8).tobytes()


dest = [payload(pid, d) for d in range(k)]
# max_bytes=300k: no process RECEIVES more than ~206k; chunk_bytes=64k
# keeps every message small whatever the hot payload's size.
got = _alltoall_bytes(dest, max_bytes=300_000, chunk_bytes=64_000)
ok = all(got[s] == payload(s, pid) for s in range(k))
print(json.dumps({"pid": pid, "ok": bool(ok),
                  "checks": {"skew_alltoall": bool(ok)}}), flush=True)
sys.exit(0 if ok else 1)
"""

#: Root of the checkout (the children's import path).
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="heatmap_tpu_torch.tools.multiproc_check")
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--skew-only", action="store_true",
                    help="run only the skewed byte-exchange check "
                         "(fast; use --k 4 to exercise several shift "
                         "rounds)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from heatmap_tpu_torch.devices import resolve_device
    from heatmap_tpu_torch.tools._common import HOST_FIELDS, device_fields

    # The skew exchange moves host bytes only; the full check's children
    # run their cascades on the device.
    dev = resolve_device(args.device)
    child_src = _SKEW_CHILD if args.skew_only else _CHILD

    work = tempfile.mkdtemp(prefix="multiproc-check-")
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    coord = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", child_src, coord, str(i), str(args.k),
             str(args.n), work, dev.type],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for i in range(args.k)
    ]
    ok = True
    reports = []
    # --timeout is one budget for all the children; every child is
    # reaped before exit.
    deadline = time.monotonic() + args.timeout
    try:
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())
                )
            except subprocess.TimeoutExpired:
                ok = False
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                out, err = p.communicate()
            for line in out.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
                    reports.append(json.loads(line))
            if p.returncode != 0:
                ok = False
                tail = err.strip().splitlines()[-8:]
                print(f"[child rc={p.returncode}] " + " | ".join(tail),
                      file=sys.stderr, flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(work, ignore_errors=True)
    ok = ok and len(reports) == args.k and all(r["ok"] for r in reports)
    launches: dict = {}
    for r in reports:
        for name, count in r.get("launches", {}).items():
            launches[name] = launches.get(name, 0) + count
    print(json.dumps({
        "check": "multiproc", "ok": ok, "k": args.k, "n": args.n,
        "s": round(time.perf_counter() - t0, 1), "launches": launches,
        **(HOST_FIELDS if args.skew_only else device_fields(dev)),
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
