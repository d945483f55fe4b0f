"""Kernel-epoch hashing of the port's card tooling.

The port's twin of ``tools/_epoch.py``. The "kernel epoch" is a short
content hash over every source file whose edit invalidates recorded
verdicts on the card: the CUDA kernels under test, their Python
wrappers, AND the plain versions the expected values come from. The
verify twin (``verify_partitioned_onchip``) prefixes its state keys
with it, and ``apply_decisions`` refuses to act on seg-* verdicts of
another epoch.

Standard library only: it must never import torch or the package just
to compute a hash. Load it by path, without importing
``heatmap_tpu_torch``:

    spec = importlib.util.spec_from_file_location(
        "_epoch", os.path.join(TOOLS_DIR, "_epoch.py"))
"""

from __future__ import annotations

import hashlib
import os

#: Files (relative to the heatmap_tpu_torch package root) hashed into
#: the epoch: both sides of every comparison on the card (the kernels
#: and their wrappers, the scatter references, the projection feeding
#: them).
KERNEL_FILES = (
    "csrc/segment_reduce.cu",
    "csrc/window_histogram.cu",
    "csrc/window_bucketed.cu",
    "csrc/smem_limit.cuh",
    "ops/sparse_partitioned.py",
    "ops/pallas_kernels.py",
    "ops/partitioned.py",
    "ops/histogram.py",
    "ops/sparse.py",
    "parallel/sharded.py",
    "tilemath/mercator.py",
)


def package_root() -> str:
    """Path of the heatmap_tpu_torch package, resolved from this file."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_epoch(extra_paths=()) -> str:
    """10-hex content hash over KERNEL_FILES plus ``extra_paths``.

    ``extra_paths`` folds a consumer's own source into the epoch (the
    verify twin hashes itself: a change to its cases, shapes or seeds
    must also invalidate the old verdicts, made on the old inputs).
    """
    root = package_root()
    h = hashlib.sha256()
    for rel in KERNEL_FILES:
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    for p in extra_paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:10]
