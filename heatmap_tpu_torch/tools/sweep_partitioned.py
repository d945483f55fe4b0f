"""Timings of the window kernels' and the segment reduce's plans on the
card, beside the PyTorch calls they compete with.

The port's twin of ``tools/sweep_partitioned.py``, on its headline
workload and defaults (``--n 25 --steps 5 --zoom 15``): 2^n clustered
points in the z15 window of ``window_from_bounds((44, 51), (-127,
-117), align_levels=12, pad_multiple=256)``, projected in float32 inside
each timed call as in the JAX tool. One JSON line per configuration:

- ``xla-scatter`` (the plain scatter), ``bincount`` (``torch.bincount``
  of the cell ids), ``sort-only stable=True|False`` (``torch.sort`` of
  the cell ids alone, the JAX ``sort-only`` probe) and ``sort-rows k=``;
- ``partitioned`` (the bucketed counts kernel at its own plan) and the
  plans that ``verify_partitioned_onchip`` checks (``chunks=``,
  ``groups=``, ``item_points=``), ``histogram global`` (the histogram
  kernel's global-atomic build, which the planner picks for a window of
  more than eight bands) at its plan and other grids (``blocks=``);
- ``xla-scatter weighted``, ``bincount weighted`` and ``partitioned
  weighted k=8`` (the weighted bucketed kernel; ``streams`` shapes only
  the TPU formulation and is only validated here, so the JAX name's k=8
  is the one kernel);
- ``cascade-level scatter|partitioned`` and ``cascade-pyramid16
  scatter|partitioned``: one level, and the 16-level pyramid, of 2^n
  clustered composite keys on the plain scatter reduce and on the
  segment-reduce kernel.

Every kernel row is first held bit-equal to the plain version, then
timed: ``ms`` is the median of ``--steps`` calls, each between its own
pair of CUDA events, after one warm-up; ``device_us`` the device time
per call by ``torch.profiler``. The rows that ``apply_decisions`` reads
keep the JAX names. ``--state FILE`` appends each row as it lands and a
re-run skips the configurations already measured. The last line is the
record: the kernels' launches, the card's name and power limit.

    python -m heatmap_tpu_torch.tools.sweep_partitioned [--n 25]
        [--steps 5] [--zoom 15] [--state FILE] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys

import numpy as np

#: The bucketed counts kernel's plans swept beside its own.
BUCKETED_PLANS = ({"chunks": 64}, {"chunks": 4096}, {"groups": 4},
                  {"item_points": 1024}, {"item_points": 1 << 16})
#: Grids of the histogram kernel's global-atomic build.
GLOBAL_BLOCKS = (264, 1056)


def _load_state(path):
    if not path or not os.path.exists(path):
        return {}
    out = {}
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn final line from a killed writer
            if "config" in rec:
                out[rec["config"]] = rec
    return out


def cuda_ms(fn, steps):
    """Median milliseconds of ``fn()`` over ``steps`` calls after one
    warm-up, each call between its own pair of CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_us(fn, iters):
    """Device microseconds per call of ``fn`` (all its kernels), from
    ``torch.profiler``'s CUDA activity over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", 0)
               for e in prof.key_averages()) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="heatmap_tpu_torch.tools.sweep_partitioned")
    ap.add_argument("--n", type=int, default=25, help="log2 point count")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--zoom", type=int, default=15)
    ap.add_argument("--state", default=None,
                    help="JSONL checkpoint; measured configs are skipped")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    state = _load_state(args.state)

    from heatmap_tpu_torch.devices import resolve_device

    dev = resolve_device(args.device)
    # On the CPU the wrappers run their plain versions: there is no
    # kernel to time.
    if dev.type == "cpu":
        print(json.dumps({"error": "refusing to sweep on the CPU (the "
                          "wrappers run their plain versions there)",
                          "device": dev.type}))
        return 2
    return sweep(dev, args, state)


def sweep(dev, args, state) -> int:
    """Every row on ``dev`` (a card) at ``args.n``, ``args.steps`` and
    ``args.zoom``, rows appended to ``args.state``; skips the configs in
    ``state``."""
    import torch

    from heatmap_tpu_torch.ops import pallas_kernels as pk
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.ops import window_from_bounds
    from heatmap_tpu_torch.ops.histogram import _scatter_window
    from heatmap_tpu_torch.ops.partitioned import (
        bin_rowcol_window_partitioned,
        cell_ids,
    )
    from heatmap_tpu_torch.ops.pyramid import (
        pyramid_sparse_morton,
        pyramid_sparse_morton_partitioned,
    )
    from heatmap_tpu_torch.ops.sparse import aggregate_sorted_keys
    from heatmap_tpu_torch.tilemath import mercator
    from heatmap_tpu_torch.tools import verify_partitioned_onchip as vp
    from heatmap_tpu_torch.tools._common import append_line, device_fields

    win = window_from_bounds((44.0, 51.0), (-127.0, -117.0), zoom=args.zoom,
                             align_levels=min(12, args.zoom),
                             pad_multiple=256)
    hw = win.height * win.width
    n = 1 << args.n
    rng = np.random.default_rng(0)
    n_hot = n // 4
    lat = np.concatenate([47.6 + rng.normal(0, 0.5, n - n_hot),
                          47.6 + rng.normal(0, 0.02, n_hot)]).astype(np.float32)
    lon = np.concatenate([-122.3 + rng.normal(0, 0.7, n - n_hot),
                          -122.3 + rng.normal(0, 0.03, n_hot)]).astype(np.float32)
    dla = torch.as_tensor(lat, device=dev)
    dlo = torch.as_tensor(lon, device=dev)
    sms = pk._sms(dev.index if dev.index is not None
                  else torch.cuda.current_device())
    seg = sp.aggregate_sorted_keys_partitioned
    seg.launches = 0
    pk.bin_rowcol_window_pallas.launches = 0
    bin_rowcol_window_partitioned.launches = 0
    bin_rowcol_window_partitioned.weighted_launches = 0
    errors = 0

    def project():
        return mercator.project_points(dla, dlo, win.zoom,
                                       dtype=torch.float32)

    def report(name, fn, **extra):
        ms = cuda_ms(fn, args.steps)
        rec = {"config": name, "ms": ms, "mpts_per_s": n / ms / 1e3,
               "device_us": device_us(fn, args.steps), **extra}
        print(json.dumps(rec), flush=True)
        if args.state:
            append_line(args.state, rec)

    def measured(name):
        if name in state:
            print(json.dumps({**state[name], "cached": True}), flush=True)
            return True
        return False

    def row(name, fn, want=None, **extra):
        """Check ``fn()`` against ``want()`` (bit-equal), then time it;
        a failure is an error line, and the sweep goes on."""
        nonlocal errors
        if measured(name):
            return
        try:
            if want is not None:
                got, expected = fn(), want()
                same = (got.dtype == expected.dtype
                        and torch.equal(got, expected))
                del got, expected
                if not same:
                    raise AssertionError("differs from the plain version")
                extra["bit_exact"] = True
            report(name, fn, **extra)
        except Exception as e:  # noqa: BLE001 (keep sweeping)
            errors += 1
            print(json.dumps({"config": name,
                              "error": f"{type(e).__name__}: {e}"[:200]}),
                  flush=True)

    def ids():
        r, c, v = project()
        return cell_ids(r, c, win, v)

    def scatter():
        r, c, v = project()
        return _scatter_window(r, c, win, valid=v)

    row("xla-scatter", scatter)
    row("bincount", lambda: torch.bincount(
        ids(), minlength=hw + 1)[:hw].to(torch.int32).reshape(
            win.height, win.width), want=scatter)
    for stable in (True, False):
        row(f"sort-only stable={stable}",
            lambda st=stable: torch.sort(ids(), stable=st).values)
    for k in (8, 32, 128):
        row(f"sort-rows k={k}",
            lambda kk=k: torch.sort(ids().reshape(kk, -1), dim=1).values)

    def part(**plan_kw):
        def run():
            r, c, v = project()
            if not plan_kw:
                return bin_rowcol_window_partitioned(r, c, win, valid=v)
            r, c, _, v = pk._points(r, c, None, v)
            plan, item = vp.bucketed_plan(win, n, **plan_kw)
            return vp.launch_bucketed(r, c, win, None, v, plan, item)
        return run

    row("partitioned", part(), want=scatter)
    for plan_kw in BUCKETED_PLANS:
        name = "partitioned " + " ".join(f"{k}={v}"
                                         for k, v in plan_kw.items())
        row(name, part(**plan_kw), want=scatter, **plan_kw)

    def hist(blocks=None):
        def run():
            r, c, v = project()
            if blocks is None:
                return pk.bin_rowcol_window_pallas(r, c, win, valid=v)
            r, c, _, v = pk._points(r, c, None, v)
            plan = vp.histogram_plan(win, n, sms, blocks=blocks)
            return vp.launch_histogram(r, c, win, None, v, plan)
        return run

    row("histogram global", hist(), want=scatter,
        plan=list(dataclasses.astuple(pk.plan_histogram(win, n, sms))))
    for blocks in GLOBAL_BLOCKS:
        row(f"histogram global blocks={blocks}", hist(blocks), want=scatter,
            blocks=blocks)

    # Weighted binning: integer weights (order-free float sums, exact
    # below 2^24 a cell), the kernel against the weighted scatter.
    dw = torch.as_tensor(rng.integers(1, 16, n).astype(np.float32),
                         device=dev)

    def scatter_w():
        r, c, v = project()
        return _scatter_window(r, c, win, weights=dw, valid=v)

    def part_w():
        r, c, v = project()
        return bin_rowcol_window_partitioned(r, c, win, weights=dw, valid=v)

    def bincount_w():
        return torch.bincount(ids(), weights=dw, minlength=hw + 1)[
            :hw].to(torch.float32).reshape(win.height, win.width)

    row("xla-scatter weighted", scatter_w)
    row("bincount weighted", bincount_w)
    row("partitioned weighted k=8", part_w, want=scatter_w,
        streams="validated only")
    del dw

    # The cascade's segment reduce: clustered composite keys (z21-like
    # codes), one level and the 16-level pyramid.
    kn = n
    kkeys = np.sort(
        rng.choice(1 << 42, max(kn // 8, 1), replace=False)[
            rng.integers(0, max(kn // 8, 1), kn)
        ].astype(np.int64))
    dkeys = torch.as_tensor(kkeys, device=dev)
    del kkeys
    ones = torch.ones(kn, dtype=torch.int32, device=dev)
    sent = torch.iinfo(torch.int64).max

    def level_scatter():
        return aggregate_sorted_keys(dkeys, ones, kn, sentinel=sent)[1]

    def level_kernel():
        return seg(dkeys, kn, sentinel=sent)[1]

    def pyr_scatter():
        return pyramid_sparse_morton(dkeys, levels=16, capacity=kn)[-1][1]

    def pyr_kernel():
        return pyramid_sparse_morton_partitioned(dkeys, levels=16,
                                                 capacity=kn)[-1][1]

    row("cascade-level scatter", level_scatter)
    row("cascade-level partitioned", level_kernel, want=level_scatter)
    row("cascade-pyramid16 scatter", pyr_scatter)
    row("cascade-pyramid16 partitioned", pyr_kernel, want=pyr_scatter)
    print(json.dumps({
        "n": n, "steps": args.steps, "zoom": args.zoom,
        "window": [win.height, win.width], "errors": errors,
        "launches": {
            "segment_reduce": seg.launches,
            "window_histogram": pk.bin_rowcol_window_pallas.launches,
            "window_partitioned": bin_rowcol_window_partitioned.launches,
            "window_partitioned_weighted":
                bin_rowcol_window_partitioned.weighted_launches},
        **device_fields(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
