"""Bit-exactness of the hand-written CUDA kernels on the card against
their plain versions, across the plans the port's planners can choose.

The port's twin of ``tools/verify_partitioned_onchip.py``. The CPU
tests hold each wrapper to the JAX package on its plain version; what
the card compiles and runs is checked only here and in
``chip_smoke.py``. The cases are the JAX tool's, at its sizes: clustered,
adversarial-uniform and pileup points (2^22) in the z15 headline window
(``window_from_bounds((44, 51), (-127, -117), zoom=15, align_levels=12,
pad_multiple=256)``), with integer weights, with the float64
projection ("x64"), on a one-device mesh, and 2^22 sorted keys for the
segment reduce (``seg-clustered``, ``seg-unique``, ``seg-pileup``).

The combos are the plans of the CUDA kernels, where the JAX tool swept
the TPU tiling (``block_cells``, ``chunk``, ``bad_frac``, ``streams``):

- ``bucketed``: ``partitioned.plan_counts``'s grids (``chunks``,
  ``groups``, ``item_points``) for the counts and the weighted kernel;
- ``histogram``: ``pallas_kernels.plan_histogram``'s global-atomic
  build at the headline window (``blocks``) and its banded build at a
  256 x 256 window on the hot spot (``walkers``);
- the segment reduce, whose plan is fixed: padded sentinel tails (an
  eighth and a half of the lanes, ROADMAP H8), a shifted level read and
  integer weights.

The default plan goes through the package's wrapper (its launch count
moves); every other plan through this tool's private launcher, which
calls the kernel's C interface with the plan given. Counts and integer
weights must be bit-equal; fractional weights (``fractional`` cases)
are held, like the plain version, within FRACTIONAL_RTOL of a float64
sum (ROADMAP H2).

``--state FILE`` records each (case, combo) verdict as it lands, keyed
by the kernel epoch (``_epoch.py``), and a re-run skips the settled
ones; ``--retry-errors`` re-runs those that failed to launch. Exit
codes as in the JAX tool: 0 bit-exact, 1 a mismatch, 3 combos that
errored, 4 transient skips, and 2 on the CPU (``--device cpu``), where
the kernels do not run and there is nothing to verify.

    python -m heatmap_tpu_torch.tools.verify_partitioned_onchip
        [--state build/torch_onchip_state/verify.jsonl] [--retry-errors]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _load_epoch_mod():
    """Load ``_epoch.py`` by path (it must not import the package)."""
    import importlib.util

    p = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_epoch.py")
    spec = importlib.util.spec_from_file_location("_epoch", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_epoch():
    """Hash of the kernel sources and plain versions under verification,
    and of this tool (its cases, shapes and seeds made the verdicts).
    State keys carry it, so an edit to any of them invalidates every
    recorded verdict."""
    return _load_epoch_mod().kernel_epoch(
        extra_paths=(os.path.abspath(__file__),))


EPOCH = _kernel_epoch()
RETRY_ERRORS = False

#: Combos skipped this run on a transient failure: not settled into
#: state, so they stay unverified under the current epoch, and the exit
#: code says so.
TRANSIENT_SKIPS = 0

#: Fractional weights: relative error to the float64 sum (ROADMAP H2).
FRACTIONAL_RTOL = 1e-4
N_POINTS = 1 << 22
N_KEYS = 1 << 22
SEG_WEIGHT_BOUND = 100


def _ek(key):
    return f"{EPOCH}|{key}"


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
            out.update(rec)
    return out


def _append_state(path, state, key, ok):
    state[_ek(key)] = ok
    if not path:
        return
    from heatmap_tpu_torch.tools._common import append_line

    append_line(path, {_ek(key): ok})


def _settled(state, key):
    """Settled: bit-exact under the current epoch, or failed to launch
    (``"error:..."``) unless ``--retry-errors``."""
    v = state.get(_ek(key))
    if v is True:
        return True
    return (not RETRY_ERRORS
            and isinstance(v, str) and v.startswith("error:"))


#: Exception types of a transient failure: not settled, retried on the
#: next run.
_TRANSIENT_EXC_TYPES = (ConnectionError, TimeoutError, OSError)
#: Status names a runtime puts at the head of a transient failure's
#: message (parsed from the prefix, never matched anywhere in it).
_TRANSIENT_GRPC_CODES = frozenset({
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "CANCELLED",
})


def _is_transient(e: BaseException) -> bool:
    if isinstance(e, _TRANSIENT_EXC_TYPES):
        return True
    head = str(e).lstrip().split(":", 1)[0].strip().upper()
    return head in _TRANSIENT_GRPC_CODES


def _run_combo(state_path, state, key, fn):
    """Run one combo; a launch failure is recorded and reported instead
    of ending the run. Returns the result or None on failure."""
    global TRANSIENT_SKIPS
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 (record any failure on the card)
        msg = f"{type(e).__name__}: {str(e)[:300]}"
        if _is_transient(e):
            TRANSIENT_SKIPS += 1
            print(json.dumps({"combo": key, "transient": msg}), flush=True)
            return None
        _append_state(state_path, state, key, f"error:{msg}")
        print(json.dumps({"combo": key, "error": f"error:{msg}"}),
              flush=True)
        return None


def _epoch_tally(state):
    ok = fail = err = 0
    prefix = f"{EPOCH}|"
    for k, v in state.items():
        if not k.startswith(prefix):
            continue
        if v is True:
            ok += 1
        elif v is False:
            fail += 1
        elif isinstance(v, str) and v.startswith("error:"):
            err += 1
    return ok, fail, err


def _verdict(fail_n: int, err_n: int, transients: int) -> str:
    if fail_n:
        return "MISMATCH"
    if transients:
        return "UNSETTLED"
    return "BIT-EXACT+ERRORS" if err_n else "BIT-EXACT"


def _final_rc(fail_n: int, err_n: int, transients: int) -> int:
    """1 a mismatch; 4 transient skips (unverified, so not passed); 3
    combos that never ran; else 0."""
    if fail_n:
        return 1
    if transients:
        return 4
    return 3 if err_n else 0


# ------------------------------------------------------------- launchers

def bucketed_plan(window, n, chunks=None, groups=None, item_points=None):
    """``(plan, item_points)``: ``partitioned.plan_counts`` with the
    named grid fields replaced (the rest recomputed to stay legal)."""
    from heatmap_tpu_torch.ops import partitioned as pt

    plan = pt.plan_counts(window, n)
    item = pt.ITEM_POINTS if item_points is None else item_points
    chunks = plan.chunks if chunks is None else chunks
    groups = plan.groups if groups is None else groups
    per_chunk = -(-n // (4 * chunks)) * 4
    plan = dataclasses.replace(
        plan, chunks=chunks, groups=groups, per_chunk=per_chunk,
        items_max=-(-n // item) + plan.buckets)
    if plan.group_buckets > pt.GROUP_BUCKETS:
        raise ValueError(f"{groups} groups leave {plan.group_buckets} "
                         "buckets a group, over GROUP_BUCKETS")
    return plan, item


def launch_bucketed(row, col, window, weights, valid, plan, item_points):
    """The bucketed counts (or weighted) kernel under ``plan``: the
    package's ``partitioned._launch`` with the plan given, uncounted."""
    import torch

    from heatmap_tpu_torch import _build
    from heatmap_tpu_torch.ops import partitioned as pt
    from heatmap_tpu_torch.ops.pallas_kernels import check_launch, raw_stream

    n = row.shape[0]
    dev = row.device
    lib = _build.load("window_bucketed", pt._SIGNATURES)
    dtype = torch.int32 if weights is None else torch.float32
    out = torch.empty(window.height, window.width, device=dev, dtype=dtype)
    scratch = torch.empty(plan.scratch_words(n, weights is not None),
                          dtype=torch.int32, device=dev)
    bucket_count = scratch.data_ptr()
    chunk_base = bucket_count + 4 * plan.buckets
    bucket_start = chunk_base + 4 * plan.chunks * plan.buckets
    item_start = bucket_start + 4 * (plan.buckets + 1)
    cells = bucket_count + 4 * plan.cells_offset
    valid_ptr = None if valid is None else valid.data_ptr()
    geometry = (window.row0, window.col0, window.height, window.width,
                pt.SUB_SIDE, plan.sub_cols, plan.buckets, plan.group_buckets,
                plan.groups, plan.chunks, plan.per_chunk, item_points,
                plan.items_max, bucket_count, chunk_base, bucket_start,
                item_start, cells)
    with torch.cuda.device(dev):
        stream = raw_stream(dev)
        if weights is None:
            check_launch(lib.hm_window_bucketed_counts(
                row.data_ptr(), col.data_ptr(), valid_ptr, n, *geometry,
                out.data_ptr(), stream), "hm_window_bucketed_counts")
        else:
            wcells = bucket_count + 4 * plan.weights_offset(n)
            check_launch(lib.hm_window_bucketed_weighted(
                row.data_ptr(), col.data_ptr(), valid_ptr,
                weights.data_ptr(), n, *geometry, wcells, out.data_ptr(),
                stream), "hm_window_bucketed_weighted")
    return out


def histogram_plan(window, n, sms, walkers=None, blocks=None):
    """``pallas_kernels.plan_histogram``'s plan with ``walkers`` groups
    of its bands (banded build) or ``blocks`` blocks (global build)."""
    from heatmap_tpu_torch.ops import pallas_kernels as pk

    plan = pk.plan_histogram(window, n, sms)
    if walkers is not None:
        if not plan.bands:
            raise ValueError("walkers need a banded plan")
        plan = dataclasses.replace(plan, blocks=walkers * plan.bands)
    if blocks is not None:
        if plan.bands:
            raise ValueError("blocks name the global build's grid")
        plan = dataclasses.replace(plan, blocks=blocks)
    return plan


def launch_histogram(row, col, window, weights, valid, plan):
    """The window-histogram kernel under ``plan``, uncounted."""
    import torch

    from heatmap_tpu_torch import _build
    from heatmap_tpu_torch.ops import pallas_kernels as pk

    dev = row.device
    lib = _build.load("window_histogram", pk._SIGNATURES)
    dtype = torch.int32 if weights is None else torch.float32
    out = torch.empty(window.height, window.width, device=dev, dtype=dtype)
    geometry = (window.row0, window.col0, window.height, window.width,
                plan.bands, plan.slice_shift, plan.blocks)
    valid_ptr = None if valid is None else valid.data_ptr()
    with torch.cuda.device(dev):
        stream = pk.raw_stream(dev)
        if weights is None:
            pk.check_launch(lib.hm_window_histogram_counts(
                row.data_ptr(), col.data_ptr(), valid_ptr, row.shape[0],
                *geometry, out.data_ptr(), stream),
                "hm_window_histogram_counts")
        else:
            pk.check_launch(lib.hm_window_histogram_weighted(
                row.data_ptr(), col.data_ptr(), valid_ptr,
                weights.data_ptr(), row.shape[0], *geometry, out.data_ptr(),
                stream), "hm_window_histogram_weighted")
    return out


def window_call(kw, row, col, window, weights, valid, sms):
    """The raster of combo ``kw`` (its ``kernel`` and plan fields): the
    package's wrapper when no plan field is named, else the private
    launcher."""
    from heatmap_tpu_torch.ops.pallas_kernels import (
        _points,
        bin_rowcol_window_pallas,
    )
    from heatmap_tpu_torch.ops.partitioned import (
        bin_rowcol_window_partitioned,
    )

    plan_kw = {k: v for k, v in kw.items() if k not in ("kernel", "window")}
    if kw["kernel"] == "bucketed":
        if not plan_kw:
            return bin_rowcol_window_partitioned(
                row, col, window, weights=weights, valid=valid)
        row, col, weights, valid = _points(row, col, weights, valid)
        plan, item = bucketed_plan(window, row.shape[0], **plan_kw)
        return launch_bucketed(row, col, window, weights, valid, plan, item)
    if not plan_kw:
        return bin_rowcol_window_pallas(row, col, window, weights=weights,
                                        valid=valid)
    row, col, weights, valid = _points(row, col, weights, valid)
    plan = histogram_plan(window, row.shape[0], sms, **plan_kw)
    return launch_histogram(row, col, window, weights, valid, plan)


def fractional_ok(got, row, col, window, weights, valid):
    """``got`` within FRACTIONAL_RTOL of the float64 sum of the same
    weights, cell by cell."""
    from heatmap_tpu_torch.ops.histogram import _scatter_window

    import torch

    ref = _scatter_window(row, col, window, weights=weights.double(),
                          valid=valid, dtype=torch.float64)
    rel = ((got.double() - ref).abs() / ref.abs().clamp(min=1e-30)).max()
    return float(rel) <= FRACTIONAL_RTOL


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="heatmap_tpu_torch.tools.verify_partitioned_onchip")
    ap.add_argument("--state", default=None,
                    help="JSONL checkpoint; verified combos are skipped")
    ap.add_argument("--retry-errors", action="store_true",
                    help="re-run combos recorded as launch errors")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    global RETRY_ERRORS
    RETRY_ERRORS = args.retry_errors
    state = _load_state(args.state)
    print(json.dumps({"kernel_epoch": EPOCH}), flush=True)

    from heatmap_tpu_torch.devices import resolve_device

    dev = resolve_device(args.device)
    # On the CPU every wrapper takes its plain version: the very thing
    # the kernels are held to. Only the card has something to verify.
    if dev.type == "cpu":
        print(json.dumps({"error": "refusing to verify on the CPU (the "
                          "wrappers run their plain versions there)",
                          "device": dev.type}))
        return 2
    return verify(dev, args.state, state)


def verify(dev, state_path, state) -> int:
    """Every case and combo on ``dev`` (a card), verdicts appended to
    ``state_path`` and ``state``; returns the exit code."""
    import torch

    from heatmap_tpu_torch.ops import pallas_kernels as pk
    from heatmap_tpu_torch.ops import sparse_partitioned as sp
    from heatmap_tpu_torch.ops import window_from_bounds
    from heatmap_tpu_torch.ops.histogram import Window, _plain
    from heatmap_tpu_torch.parallel import (
        bin_points_replicated,
        bin_points_rowsharded,
        make_mesh,
    )
    from heatmap_tpu_torch.tilemath import mercator
    from heatmap_tpu_torch.tilemath.tile import (
        _column_from_longitude,
        _row_from_latitude,
    )
    from heatmap_tpu_torch.tools._common import device_fields

    win = window_from_bounds((44.0, 51.0), (-127.0, -117.0), zoom=15,
                             align_levels=12, pad_multiple=256)
    hot = Window(15, _row_from_latitude(47.6, 15) - 128,
                 _column_from_longitude(-122.3, 15) - 128, 256, 256)
    windows = {"headline": win, "hot256": hot}
    sms = pk._sms(dev.index if dev.index is not None
                  else torch.cuda.current_device())
    rng = np.random.default_rng(0)
    n = N_POINTS

    def project(lat, lon, dtype=torch.float32):
        return mercator.project_points(
            torch.as_tensor(lat, device=dev), torch.as_tensor(lon,
                                                              device=dev),
            win.zoom, dtype=dtype)

    cases = {}
    # Clustered: a hot core and a sparse fringe.
    lat = np.concatenate([47.6 + rng.normal(0, 0.02, n // 2),
                          47.6 + rng.normal(0, 0.8, n // 2)]).astype(np.float32)
    lon = np.concatenate([-122.3 + rng.normal(0, 0.03, n // 2),
                          -122.3 + rng.normal(0, 1.2, n // 2)]).astype(np.float32)
    cases["clustered"] = (lat, lon)
    # Uniform over the whole window: every sub-block and band is hit.
    cases["uniform"] = (
        rng.uniform(44.0, 51.0, n).astype(np.float32),
        rng.uniform(-127.0, -117.0, n).astype(np.float32),
    )
    # Out-of-window points and one cell holding 7/8 of them.
    lat = np.full(n, 47.6, np.float32)
    lon = np.full(n, -122.3, np.float32)
    lat[: n // 8] = rng.uniform(-60.0, 85.0, n // 8)
    lon[: n // 8] = rng.uniform(-180.0, 179.9, n // 8)
    cases["pileup"] = (lat, lon)

    #: Each combo names its kernel; plan fields other than the default
    #: go through the private launchers.
    combos = [
        {"kernel": "bucketed"},
        {"kernel": "bucketed", "chunks": 64},
        {"kernel": "bucketed", "chunks": 4096},
        {"kernel": "bucketed", "groups": 4},
        {"kernel": "bucketed", "item_points": 1024},
        {"kernel": "bucketed", "item_points": 1 << 16},
        {"kernel": "histogram"},
        {"kernel": "histogram", "blocks": 264},
        {"kernel": "histogram", "blocks": 1056},
        {"kernel": "histogram", "window": "hot256"},
        {"kernel": "histogram", "window": "hot256", "walkers": 8},
        {"kernel": "histogram", "window": "hot256", "walkers": 33},
    ]
    done = 0

    def check_window_section(section, names, combos, proj_dtype, weights):
        """Every (case, combo) of one section: ``weights`` None (counts),
        an integer tensor (bit-equal) or ``("fractional", tensor)``."""
        nonlocal done
        frac = isinstance(weights, tuple)
        w = weights[1] if frac else weights
        for name in names:
            keys = {json.dumps(kw, sort_keys=True): kw for kw in combos}
            prefix = f"{name}|{section}|" if section else f"{name}|"
            if all(_settled(state, prefix + k) for k in keys):
                done += len(keys)
                continue
            lat, lon = cases[name]
            r, c, v = project(lat, lon, proj_dtype)
            expected = {}
            for k, kw in keys.items():
                key = prefix + k
                if _settled(state, key):
                    done += 1
                    continue
                window = windows[kw.get("window", "headline")]
                got = _run_combo(state_path, state, key,
                                 lambda: window_call(kw, r, c, window, w, v,
                                                     sms))
                if got is None:
                    done += 1
                    continue
                if frac:
                    ok = fractional_ok(got, r, c, window, w, v)
                else:
                    if window not in expected:
                        expected[window] = _plain(r, c, window, w, v)
                    want = expected[window]
                    ok = bool(got.dtype == want.dtype
                              and torch.equal(got, want))
                _append_state(state_path, state, key, ok)
                done += 1
                line = {"case": name, "kw": kw, "bit_exact": ok}
                if section:
                    line[section] = True
                if w is None:
                    line["total"] = int(got.sum())
                print(json.dumps(line), flush=True)
                if not ok and not frac:
                    bad = torch.nonzero(got != expected[window])[:5]
                    print(f"  first diffs at {bad.tolist()}", flush=True)
                del got
            del r, c, v, expected

    # Counts, f32 projection.
    check_window_section("", tuple(cases), combos, torch.float32, None)

    # Integer weights: order-free sums, bit-exact provided every cell's
    # sum stays below 2^24 (the pileup cell: 3.7M points of weight <= 3).
    w_int = torch.as_tensor(rng.integers(0, 4, n).astype(np.float32),
                            device=dev)
    weighted_combos = [
        {"kernel": "bucketed"},
        {"kernel": "bucketed", "chunks": 4096},
        {"kernel": "bucketed", "item_points": 1024},
        {"kernel": "histogram"},
        {"kernel": "histogram", "blocks": 264},
        {"kernel": "histogram", "window": "hot256"},
        {"kernel": "histogram", "window": "hot256", "walkers": 8},
    ]
    check_window_section("weighted", tuple(cases), weighted_combos,
                         torch.float32, w_int)

    # Fractional weights (float atomics: within FRACTIONAL_RTOL of the
    # float64 sum), where no cell piles up millions of adds.
    w_frac = torch.as_tensor(rng.random(n).astype(np.float32), device=dev)
    frac_combos = [
        {"kernel": "bucketed"},
        {"kernel": "bucketed", "item_points": 1024},
        {"kernel": "histogram", "window": "hot256"},
        {"kernel": "histogram", "window": "hot256", "walkers": 8},
    ]
    check_window_section("fractional", ("clustered", "uniform"),
                         frac_combos, torch.float32, ("fractional", w_frac))

    # The float64 projection (the batch job's and the tiles command's
    # precision), counts and integer weights.
    x64_combos = [
        {"kernel": "bucketed"},
        {"kernel": "bucketed", "chunks": 4096},
        {"kernel": "histogram", "window": "hot256"},
        {"kernel": "histogram", "window": "hot256", "walkers": 8},
    ]
    check_window_section("x64", ("clustered", "pileup"), x64_combos,
                         torch.float64, None)
    check_window_section("x64|weighted", ("clustered", "pileup"),
                         x64_combos, torch.float64, w_int)

    # A one-device mesh: the sharded binning's merges (the replicated
    # sum and the row blocks) over the bucketed kernel.
    mesh1 = make_mesh(data=1, tile=1, devices=[dev])
    lat, lon = cases["clustered"]
    dla = torch.as_tensor(lat, dtype=torch.float64, device=dev)
    dlo = torch.as_tensor(lon, dtype=torch.float64, device=dev)
    mesh_fns = {
        "mesh1|x64|replicated-partitioned": lambda: bin_points_replicated(
            dla, dlo, win, mesh1, backend="partitioned",
            proj_dtype=torch.float64),
        "mesh1|x64|rowsharded-partitioned": lambda: bin_points_rowsharded(
            dla, dlo, win, mesh1, backend="partitioned",
            proj_dtype=torch.float64),
    }
    expected_mesh = None
    for key, fn in mesh_fns.items():
        if _settled(state, key):
            done += 1
            continue
        if expected_mesh is None:
            r, c, v = mercator.project_points(dla, dlo, win.zoom,
                                              dtype=torch.float64)
            expected_mesh = _plain(r, c, win, None, v)
            del r, c, v
        got = _run_combo(state_path, state, key, fn)
        if got is None:
            done += 1
            continue
        ok = bool(torch.equal(got.to(expected_mesh.device),
                              expected_mesh))
        _append_state(state_path, state, key, ok)
        done += 1
        print(json.dumps({"case": key, "bit_exact": ok}), flush=True)
    del dla, dlo, expected_mesh

    # The cascade's segment reduce: bit-exact against the plain scatter
    # reduce on the same keys.
    sent = torch.iinfo(torch.int64).max
    kn = N_KEYS
    kcases = {
        "seg-clustered": np.sort(
            rng.choice(1 << 42, kn // 64, replace=False)[
                rng.integers(0, kn // 64, kn)
            ].astype(np.int64)),
        "seg-unique": np.sort(
            rng.choice(1 << 50, kn, replace=False).astype(np.int64)),
        "seg-pileup": np.sort(np.concatenate([
            np.full(kn - kn // 8, 123456789, np.int64),
            rng.choice(1 << 40, kn // 8, replace=False).astype(np.int64),
        ])),
    }
    seg_weights = rng.integers(0, SEG_WEIGHT_BOUND + 1, kn + kn // 2
                               ).astype(np.float64)
    kcombos = [{}, {"sentinel_tail": 8}, {"sentinel_tail": 2},
               {"shift": 4}, {"weighted": True}]
    for name, keys in kcases.items():
        todo = [kw for kw in kcombos
                if not _settled(
                    state, f"{name}|{json.dumps(kw, sort_keys=True)}")]
        if not todo:
            done += len(kcombos)
            continue
        for kw in kcombos:
            key = f"{name}|{json.dumps(kw, sort_keys=True)}"
            if _settled(state, key):
                done += 1
                continue
            k = keys
            if kw.get("sentinel_tail"):
                # A padded batch: the sort puts its sentinel lanes last.
                k = np.concatenate([keys, np.full(kn // kw["sentinel_tail"],
                                                  sent, np.int64)])
            dk = torch.as_tensor(k, device=dev)
            shift = kw.get("shift", 0)
            dw = (torch.as_tensor(seg_weights[:len(k)], device=dev)
                  if kw.get("weighted") else None)
            bound = SEG_WEIGHT_BOUND if dw is not None else None
            shifted = sent >> shift
            want = sp._plain(dk, len(k), shifted, shift, dw, bound)
            res = _run_combo(
                state_path, state, key,
                lambda: sp.aggregate_sorted_keys_partitioned(
                    dk, len(k), sentinel=shifted, shift=shift,
                    sorted_weights=dw, weight_bound=bound))
            if res is None:
                done += 1
                continue
            m = int(want[2])
            ok = (int(res[2]) == m
                  and all(g.dtype == w.dtype and torch.equal(g, w)
                          for g, w in zip(res, want)))
            _append_state(state_path, state, key, ok)
            done += 1
            print(json.dumps({"case": name, "kw": kw, "bit_exact": ok,
                              "uniques": m}), flush=True)
            del dk, dw, want, res

    ok_n, fail_n, err_n = _epoch_tally(state)
    print(json.dumps({
        "device": dev.type,
        "kernel_epoch": EPOCH,
        "bit_exact": ok_n,
        "failures": fail_n,
        "errors": err_n,
        "transient_skips": TRANSIENT_SKIPS,
        "combos_done": done,
        "verdict": _verdict(fail_n, err_n, TRANSIENT_SKIPS),
        **device_fields(dev),
    }), flush=True)
    return _final_rc(fail_n, err_n, TRANSIENT_SKIPS)


if __name__ == "__main__":
    sys.exit(main())
