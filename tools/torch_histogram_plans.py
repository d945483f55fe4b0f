#!/usr/bin/env python
"""Sweep of the CUDA window-histogram kernel's plans on one card.

Runs ``heatmap_tpu_torch``'s histogram kernel (csrc/window_histogram.cu)
at the two shapes ``chip_smoke.py`` times it at, under a range of plans
that ``plan_histogram`` could choose: the banded build on fewer or more
walker groups, and the global-atomic build (no bands) on several grids.
Each plan is checked bit-equal against the plain PyTorch version, then
timed (device time by ``torch.profiler``, and the call by CUDA events).
It also prints the in-window points and non-zero cells of each shape,
which set how many global atomics each band's flush costs.

    python3 tools/torch_histogram_plans.py [--out chiprun_out/plans.json]

Needs one CUDA card; prints one JSON object per shape and a last line
naming the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from heatmap_tpu_torch import _build  # noqa: E402
from heatmap_tpu_torch.ops import pallas_kernels as pk  # noqa: E402
from heatmap_tpu_torch.ops.histogram import Window  # noqa: E402
from heatmap_tpu_torch.tilemath.tile import (  # noqa: E402
    _column_from_longitude,
    _row_from_latitude,
)

BANDED_WALKERS = (1, 2, 4, 8, 16, 33, 66)
GLOBAL_BLOCKS = (132, 264, 528, 1056)


def launcher(lib, window, row, col, valid, weights, plan):
    """One call of the kernel under ``plan`` (bands, slice_shift,
    blocks), returning its raster."""
    dtype = torch.int32 if weights is None else torch.float32
    geometry = (window.row0, window.col0, window.height, window.width,
                *plan)

    def run():
        out = torch.empty(window.height, window.width, device=row.device,
                          dtype=dtype)
        stream = pk.raw_stream(row.device)
        if weights is None:
            rc = lib.hm_window_histogram_counts(
                row.data_ptr(), col.data_ptr(), valid.data_ptr(),
                row.shape[0], *geometry, out.data_ptr(), stream)
        else:
            rc = lib.hm_window_histogram_weighted(
                row.data_ptr(), col.data_ptr(), valid.data_ptr(),
                weights.data_ptr(), row.shape[0], *geometry, out.data_ptr(),
                stream)
        pk.check_launch(rc, "window histogram")
        return out

    return run


def sweep(lib, window, row, col, valid, sms):
    n = row.shape[0]
    counts = pk._plain(row, col, window, None, valid)
    out = {"window": [window.height, window.width], "n": int(n),
           "in_window": int(counts.sum()),
           "nonzero_cells": int((counts != 0).sum()),
           "chosen": dataclasses.astuple(pk.plan_histogram(window, n, sms)),
           "plans": []}
    cells = window.height * window.width
    bands = -(-cells // (pk.SLICE_BYTES // 4))
    shift = (-(-cells // bands) - 1).bit_length()
    plans = [(bands, shift, w * bands) for w in BANDED_WALKERS
             if w * bands <= sms]
    plans += [(0, 0, b) for b in GLOBAL_BLOCKS]
    ints = cs.int_weights(n, row.device)
    want_w = pk._plain(row, col, window, ints, valid)
    for plan in plans:
        row_out = {"bands": plan[0], "slice_shift": plan[1],
                   "blocks": plan[2]}
        for kind, weights, want in (("counts", None, counts),
                                    ("int_weights", ints, want_w)):
            run = launcher(lib, window, row, col, valid, weights, plan)
            got = run()
            torch.cuda.synchronize()
            assert torch.equal(got, want), (plan, kind)
            row_out[kind] = {
                "ms": cs.median_ms(run),
                "device_us": sum(cs.device_us(run).values()),
            }
        out["plans"].append(row_out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = _build.load("window_histogram", pk._SIGNATURES)
    sms = pk._sms(0)
    results = []
    window, row, col, valid = cs.tiles_call(dev, *cs.SMALL_TILES_BOUNDS)
    results.append({"shape": "tiles", **sweep(lib, window, row, col, valid,
                                              sms)})
    del row, col, valid
    row, col, valid = cs.window_points(cs.N_WINDOW, 15, dev, torch.float64)
    hot_r = _row_from_latitude(47.6, 15)
    hot_c = _column_from_longitude(-122.3, 15)
    big = Window(15, hot_r - 128, hot_c - 128, 256, 256)
    results.append({"shape": "z15_256x256", **sweep(lib, big, row, col,
                                                    valid, sms)})
    for r in results:
        print(json.dumps(r), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip().splitlines()[0], "sms": sms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
