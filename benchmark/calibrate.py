"""Readings that the limits of the checks are set from.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --seconds 3 [--control]

For each seed, in one process: one run of the cell with a short window
and the numbers its check compares (the program's readings); with
``--control``, the same numbers with the control in the program's
place: the reference computed at the precision below the
configuration's (float32 tile math for float64), on the same inputs.
One JSON line per seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = {"workload": cell.name, "seed": seed}

        def control(driver):
            if args.control:
                t = time.perf_counter()
                out["control"] = {n: v for n, v, _ in driver.control()}
                out["control_s"] = time.perf_counter() - t

        t0 = time.perf_counter()
        result, checks = harness.run_cell(
            cell, seed, args.seconds, False, torch.device(args.device),
            t0, after_check=control)
        out["program"] = {n: v for n, v, _ in checks}
        out["limits"] = {n: lim for n, _, lim in checks}
        out["units"] = result["attempted"]
        out["correct"] = result["correct"]
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
