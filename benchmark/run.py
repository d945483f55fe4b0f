"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from ``--seed`` and warms up every shape
the cell uses; the window then runs the cell's units back to back for
``--seconds`` (ending with the unit under way), or, with ``--trace 1``,
the traffic file's ``trace_units`` under the profiler and then its
instrumented units. The answers are then held to the plain reference:
the numbers compared, each with its limit, are the last lines of
standard error and the ``checks`` of the result. The last line of
standard output is the result, one JSON object. Without the cards the
cell asks for, or with JAX or the JAX package loaded, the run exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # PyTorch's own kernel cache (jiterator) at a fixed place in the
    # checkout; the program's kernels build under build/torch_kernels/.
    os.environ.setdefault("TORCH_KERNEL_CACHE_PATH",
                          os.path.join(ROOT, "build", "benchmark", "torch"))

    from benchmark import harness, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), _T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"refused: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
