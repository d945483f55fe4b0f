"""Temporal plane: epoch-bucketed partial pyramids over the delta store.

The port's copy of heatmap_tpu/temporal (numpy and host code, as there):
for the same store it writes the same buckets and manifest and folds the
same bytes, so a temporal store written by either package continues in
the other.

The delta store keeps history (epoch-numbered journal entries, compacted
bases) but serves only the all-time sum. This package makes that history
queryable without changing a byte of the all-time path:

- ``buckets``  — the geometric bucket ladder (telemetry-store style
  tiers), bucket naming, the ``TEMPORAL.json`` base manifest, and the
  deterministic compaction partition plan;
- ``fold``     — partial-pyramid folds: select buckets for ``as_of`` /
  ``window`` cuts, apply per-bucket decay weights at fold time, and
  merge through the same ``io.merge`` core as the all-time overlay, so
  a fold over *all* buckets is byte-identical to the un-bucketed store;
- ``timequery``— Haar wavelet histograms over the per-bucket cell
  series (synopsis/transform.py, applied to the time axis) backing the
  bounded-error ``op=topk_growth`` /query path.

Everything here is derived data: buckets are written by compaction
(delta/compact.py) from the same journal entries as the base, verified
by the recovery sweep (delta/recover.py), and folded lazily at serve
time (serve/store.py). Decay never restamps stored bytes — it is a
scalar weight applied to bucket subtotals at fold time (linearity of
the pure-sum pyramid). See docs/temporal.md.
"""

from heatmap_tpu_torch.temporal.buckets import (
    BUCKETS_DIRNAME,
    MANIFEST_NAME,
    NONE_NAME,
    WINDOW_SECONDS,
    bucket_name,
    bucket_of,
    normalize_config,
    parse_window,
    read_manifest,
)
from heatmap_tpu_torch.temporal.fold import (
    TornBucketError,
    ensure_config,
    fold_levels,
    select_fold,
    window_variants,
)

__all__ = [
    "BUCKETS_DIRNAME",
    "MANIFEST_NAME",
    "NONE_NAME",
    "WINDOW_SECONDS",
    "TornBucketError",
    "bucket_name",
    "bucket_of",
    "ensure_config",
    "fold_levels",
    "normalize_config",
    "parse_window",
    "read_manifest",
    "select_fold",
    "window_variants",
]
