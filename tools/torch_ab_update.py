"""Parent-versus-change timing of the port's `update` path on one device.

    python3 tools/torch_ab_update.py --parent DIR [--device cuda|cpu]

Runs the same commands through ``heatmap_tpu_torch.cli.main`` in a
checkout of the parent commit (``DIR``, e.g. unpacked with ``git
archive``) and in this checkout, in turns (parent, change, change,
parent, parent, change), each in a fresh process and a fresh store: a
small warm-up ``run`` (which builds the native library and the kernels),
a base ``update`` of ``--base`` points, four increments of ``--inc``
points and a duplicate of the second. Prints one JSON line per run with
each command's seconds (host clock around the command, which ends on the
host), then the card's name and power limit. Compare the two trees
within one call only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("parent", "change", "change", "parent", "parent", "change")

_CHILD = """
import contextlib, io, json, sys, time
from heatmap_tpu_torch import cli
steps = json.loads(sys.argv[1])
out = {}
for name, argv in steps:
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    out[name] = time.perf_counter() - t0
print(json.dumps(out))
"""


def steps(root, device, base, inc):
    upd = ["update", "--journal", root, "--device", device]
    return [("warm", ["run", "--input", "synthetic:20000:0", "--output",
                      "memory:", "--device", device]),
            ("base", upd + ["--input", f"synthetic:{base}:0"]),
            *[(f"inc{s}", upd + ["--input", f"synthetic:{inc}:{s}"])
              for s in (1, 2, 3, 4)],
            ("dup", upd + ["--input", f"synthetic:{inc}:2"])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="checkout of the parent commit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--base", type=int, default=1 << 20)
    ap.add_argument("--inc", type=int, default=1 << 18)
    args = ap.parse_args(argv)
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    for name in ORDER:
        tmp = tempfile.mkdtemp()
        try:
            todo = steps(os.path.join(tmp, "store"), args.device,
                         args.base, args.inc)
            p = subprocess.run(
                [sys.executable, "-c", _CHILD, json.dumps(todo)],
                cwd=trees[name], capture_output=True, text=True)
            if p.returncode:
                print(p.stderr[-3000:], file=sys.stderr)
                return 1
            rec = {"tree": name,
                   **json.loads(p.stdout.strip().splitlines()[-1])}
            print(json.dumps(rec), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
