"""Crash-recovery sweep for the delta store.

The port's copy of heatmap_tpu/delta/recover.py: the same quarantine
decisions, reasons and events, temporal buckets included.

The store's write paths are atomic (save_checkpoint entries, tmp+rename
artifact publishes, the CURRENT pointer flip), so a crash can only
leave *garbage*, never a half-applied state the read path would serve:
orphan ``*.tmp`` staging files/dirs, a journal entry torn mid-write by
a power cut that beat the fsync, or an artifact dir whose journal
append never landed. This sweep finds all of it and moves it into
``root/quarantine/`` — quarantine, not delete, so an operator can
inspect what a chaotic run left behind — emitting one ``quarantine``
obs event per item.

What gets quarantined:

- any ``*.tmp`` entry in the root or the journal dir (crashed staging);
- journal entries that fail to load (torn npz), are missing required
  meta fields, disagree with their filename epoch, or whose
  ``entry_digest`` no longer matches the digest recomputed over the
  meta identity + artifact bytes (tampered content hash, torn or
  swapped artifact). Entries predating the digest field are legacy and
  skip digest verification;
- ``delta-XXXXXX`` dirs no surviving journal entry references (a
  crashed apply; also freed when their entry was quarantined — the
  next submit of that batch re-journals under a fresh epoch and
  re-applies cleanly, exactly once);
- ``base-XXXXXX`` dirs other than CURRENT's base (a compaction that
  crashed between publishing the new base and flipping the pointer, or
  between flipping and pruning);
- torn or schema-invalid ``synopsis-z*.npz`` artifacts inside CURRENT's
  base (and their orphan ``.tmp`` staging files). Serving already skips
  unreadable synopses — exact levels answer instead — so this step only
  makes the corruption visible and stops every reload from re-reading a
  bad file;
- torn or schema-invalid ``integral-z*.npz`` artifacts inside CURRENT's
  base, same contract (reason ``torn_integral``): /query falls through
  to the exact rows, so quarantining only surfaces the corruption;
- torn ``tilefs-z*.bin`` zero-copy mirrors inside CURRENT's base, same
  contract (reason ``torn_tilefs``, heatmap_tpu_torch.tilefs): the store
  serves the sibling npz level for that zoom, and orphan
  ``tilefs-*.tmp`` staging files.

Digest verification re-hashes artifact bytes, so results are memoised
per entry file identity (path, size, mtime_ns) — journaled entries and
their artifacts are immutable by contract, making entry-file identity a
sound cache key. ``clear_verified_cache`` resets it (tests).

Runs at ``init_store`` (the head of every apply) and at the top of
``compact``; the serve tier never sweeps — it is read-only and handles
store corruption by degrading instead (docs/robustness.md).

Quarantine growth is bounded, not infinite: every sweep refreshes the
``quarantine_bytes`` gauge, and ``prune_quarantine`` (called after each
successful compaction under the store's ``--retention`` knob) deletes
the oldest entries beyond the retention count — never an entry younger
than the minimum age, so an operator always gets a full
investigation window for recent incidents.
"""

from __future__ import annotations

import os
import re
import shutil

from heatmap_tpu_torch.delta.journal import entry_digest
from heatmap_tpu_torch.utils.checkpoint import load_checkpoint

QUARANTINE_DIRNAME = "quarantine"

_ENTRY_RE = re.compile(r"^ckpt-(\d+)\.npz$")
_DELTA_RE = re.compile(r"^delta-\d{6}$")
_BASE_RE = re.compile(r"^base-\d{6}$")

_REQUIRED_META = ("epoch", "content_hash", "artifact", "sign", "points")

# (entry abspath, size, mtime_ns) -> True for digest-verified entries.
_VERIFIED: dict = {}


def clear_verified_cache():
    _VERIFIED.clear()


def _quarantine(root: str, path: str, reason: str, kind: str,
                items: list, detail: str | None = None):
    from heatmap_tpu_torch import obs

    qdir = os.path.join(root, QUARANTINE_DIRNAME)
    os.makedirs(qdir, exist_ok=True)
    base = os.path.basename(path.rstrip(os.sep))
    dest = os.path.join(qdir, base)
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = os.path.join(qdir, f"{base}.{n}")
    try:
        shutil.move(path, dest)
    except FileNotFoundError:
        return  # concurrently removed — nothing left to quarantine
    rel = os.path.relpath(path, root)
    items.append({"path": rel, "reason": reason, "kind": kind})
    fields = {"detail": detail} if detail else {}
    obs.emit("quarantine", root=root, path=rel, reason=reason, kind=kind,
             **fields)


def quarantine_item(root: str, path: str, reason: str, kind: str,
                    items: list, detail: str | None = None):
    """Public quarantine move: relocate ``path`` under
    ``root/quarantine/`` (never delete), record it in ``items`` and as
    a ``quarantine`` event. The write plane's sweep
    (writeplane/recover.py) reuses this for torn/orphan manifests and
    ledger entries so every quarantine in the system shares one
    discipline and one event shape."""
    _quarantine(root, path, reason, kind, items, detail)


def _entry_fault(root: str, name: str, verify: bool):
    """-> (meta, reason, detail): reason is None for a valid entry."""
    path = os.path.join(root, "journal", name)
    try:
        st = os.stat(path)
        cache_key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    except OSError:
        return None, None, None  # vanished concurrently
    if cache_key in _VERIFIED:
        # Cached metas are not kept; reload (cheap — digest is the
        # expensive part and that is what the cache skips).
        verify = False
    try:
        _, meta = load_checkpoint(path)
    except Exception as e:  # torn npz, bad zip, bad meta JSON
        return None, "unreadable", repr(e)
    missing = [k for k in _REQUIRED_META if meta.get(k) is None]
    if missing:
        return meta, "malformed", f"missing fields {missing}"
    m = _ENTRY_RE.match(name)
    if m and int(meta["epoch"]) != int(m.group(1)):
        return meta, "malformed", (
            f"epoch {meta['epoch']} != filename epoch {m.group(1)}")
    recorded = meta.get("entry_digest")
    if verify and recorded is not None:
        actual = entry_digest(root, content_hash=meta["content_hash"],
                              sign=meta["sign"], points=meta["points"],
                              artifact=meta["artifact"])
        if actual != recorded:
            return meta, "digest_mismatch", (
                f"recorded {recorded[:23]}..., actual {actual[:23]}...")
        _VERIFIED[cache_key] = True
    return meta, None, None


def quarantine_bytes(root: str) -> int:
    """Total bytes under ``root/quarantine/`` (0 when absent); also
    refreshes the ``quarantine_bytes`` gauge."""
    from heatmap_tpu_torch.delta.metrics import QUARANTINE_BYTES

    qdir = os.path.join(root, QUARANTINE_DIRNAME)
    total = 0
    for dirpath, _dirs, files in os.walk(qdir):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, name))
            except OSError:
                continue  # pruned/moved concurrently
    QUARANTINE_BYTES.set(total)
    return total


def prune_quarantine(root: str, *, keep: int, min_age_s: float = 0.0,
                     now: float | None = None) -> dict:
    """Bound ``root/quarantine/`` growth: delete the oldest entries
    beyond the newest ``keep``, but NEVER an entry younger than
    ``min_age_s`` — recent quarantines are exactly the ones an operator
    investigating a live incident still needs, so age wins over count.

    The count cap rides the delta store's existing ``--retention``
    knob (delta/compact.py calls this after every successful
    compaction). Returns ``{"pruned": [names], "kept": n, "bytes":
    remaining}`` and refreshes the ``quarantine_bytes`` gauge.
    """
    import time as _time

    from heatmap_tpu_torch import obs

    if keep < 0:
        raise ValueError("keep must be >= 0")
    if now is None:
        now = _time.time()
    qdir = os.path.join(root, QUARANTINE_DIRNAME)
    pruned: list = []
    if os.path.isdir(qdir):
        entries = []
        for name in os.listdir(qdir):
            full = os.path.join(qdir, name)
            try:
                entries.append((os.path.getmtime(full), name, full))
            except OSError:
                continue
        entries.sort(reverse=True)  # newest first
        for mtime, name, full in entries[keep:]:
            if now - mtime < min_age_s:
                continue
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            else:
                try:
                    os.remove(full)
                except OSError:
                    continue
            pruned.append(name)
            obs.emit("quarantine", root=root,
                     path=os.path.join(QUARANTINE_DIRNAME, name),
                     reason="pruned", kind="prune",
                     detail=f"beyond retention keep={keep}")
    remaining = quarantine_bytes(root)
    kept = (len([n for n in os.listdir(qdir)])
            if os.path.isdir(qdir) else 0)
    return {"pruned": pruned, "kept": kept, "bytes": remaining}


def sweep(root: str, *, verify: bool = True) -> dict:
    """Quarantine crash garbage under ``root``; see module docstring.

    Returns ``{"quarantined": [{"path", "reason", "kind"}, ...]}``
    (empty list when the store is clean or ``root`` does not exist).
    """
    from heatmap_tpu_torch.delta.compact import journal_dir, read_current

    items: list = []
    if not os.path.isdir(root):
        return {"quarantined": items}

    # 1. Orphan *.tmp staging entries (root + journal dir).
    for d in (root, journal_dir(root)):
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.endswith(".tmp"):
                _quarantine(root, os.path.join(d, name), "orphan_tmp",
                            "tmp", items)

    # 2. Torn / malformed / digest-mismatched journal entries.
    jdir = journal_dir(root)
    survivors: list = []
    if os.path.isdir(jdir):
        for name in sorted(os.listdir(jdir)):
            if not _ENTRY_RE.match(name):
                continue
            meta, reason, detail = _entry_fault(root, name, verify)
            if reason is not None:
                _quarantine(root, os.path.join(jdir, name), reason,
                            "journal_entry", items, detail)
            elif meta is not None:
                survivors.append(meta)

    # 3. Delta artifacts no surviving entry references (crashed applies
    #    and the artifacts of entries quarantined above).
    referenced = {e["artifact"] for e in survivors}
    cur = read_current(root)
    for name in sorted(os.listdir(root)):
        full = os.path.join(root, name)
        if _DELTA_RE.match(name) and os.path.isdir(full):
            if name not in referenced:
                _quarantine(root, full, "orphan_artifact",
                            "delta_artifact", items)
        elif _BASE_RE.match(name) and os.path.isdir(full):
            # 4. Bases CURRENT does not point at (crashed compaction).
            if name != cur.get("base"):
                _quarantine(root, full, "orphan_base", "base", items)

    # 5. Torn synopsis / integral artifacts inside CURRENT's base.
    base = cur.get("base")
    bdir = os.path.join(root, base) if base else None
    if bdir and os.path.isdir(bdir):
        from heatmap_tpu_torch.analytics.integral import verify_integral
        from heatmap_tpu_torch.synopsis.build import verify_synopsis

        for name in sorted(os.listdir(bdir)):
            full = os.path.join(bdir, name)
            if name.startswith("synopsis-") and name.endswith(".tmp"):
                _quarantine(root, full, "orphan_tmp", "synopsis", items)
            elif name.startswith("synopsis-z") and name.endswith(".npz"):
                detail = verify_synopsis(full)
                if detail is not None:
                    _quarantine(root, full, "torn_synopsis", "synopsis",
                                items, detail)
            elif name.startswith("integral-") and name.endswith(".tmp"):
                _quarantine(root, full, "orphan_tmp", "integral", items)
            elif name.startswith("integral-z") and name.endswith(".npz"):
                detail = verify_integral(full)
                if detail is not None:
                    _quarantine(root, full, "torn_integral", "integral",
                                items, detail)
            elif name.startswith("tilefs-") and name.endswith(".tmp"):
                _quarantine(root, full, "orphan_tmp", "tilefs", items)
            elif name.startswith("tilefs-z") and name.endswith(".bin"):
                from heatmap_tpu_torch.tilefs import verify_tilefs

                detail = verify_tilefs(full)
                if detail is not None:
                    # Serving falls back to the exact npz level for that
                    # zoom, so quarantining a torn mirror costs mmap
                    # sharing, never correctness.
                    _quarantine(root, full, "torn_tilefs", "tilefs",
                                items, detail)

    # 6. Temporal buckets inside CURRENT's base (heatmap_tpu_torch.temporal):
    #    torn buckets quarantine; folds over a quarantined bucket raise
    #    TornBucketError and the serve tier answers stale-if-error,
    #    while the all-time path — which never reads buckets — is
    #    untouched.
    if bdir and os.path.isdir(bdir):
        _sweep_buckets(root, bdir, items)

    quarantine_bytes(root)  # refresh the growth gauge every sweep
    return {"quarantined": items}


def _sweep_buckets(root: str, bdir: str, items: list):
    """Verify the base's TEMPORAL.json manifest against its bucket
    dirs: a bucket whose recomputed digest mismatches the manifest
    (torn write, tampered levels) is quarantined, as is any bucket dir
    the manifest does not list (a crashed pass's stray). Digest
    results are memoised per (dir, recorded digest) — published
    buckets are immutable by contract, same stance as journal entry
    verification."""
    from heatmap_tpu_torch.temporal import buckets as tb

    subdir = os.path.join(bdir, tb.BUCKETS_DIRNAME)
    manifest = tb.read_manifest(bdir)
    if manifest is None:
        mpath = os.path.join(bdir, tb.MANIFEST_NAME)
        if os.path.isdir(subdir):
            if os.path.exists(mpath):
                # Unreadable manifest over existing buckets: temporal
                # serving for this base is gone either way; make the
                # corruption visible instead of re-parsing every read.
                _quarantine(root, mpath, "torn_manifest",
                            "temporal_manifest", items)
            for name in sorted(os.listdir(subdir)):
                _quarantine(root, os.path.join(subdir, name),
                            "orphan_bucket", "temporal_bucket", items)
        return
    listed = {}
    for b in manifest.get("buckets") or []:
        listed[b["name"]] = b.get("digest")
    if manifest.get("none"):
        listed[tb.NONE_NAME] = manifest["none"].get("digest")
    present = sorted(os.listdir(subdir)) if os.path.isdir(subdir) else []
    for name in present:
        full = os.path.join(subdir, name)
        recorded = listed.get(name)
        if recorded is None:
            _quarantine(root, full, "orphan_bucket", "temporal_bucket",
                        items)
            continue
        cache_key = (os.path.abspath(full), recorded)
        if cache_key in _VERIFIED:
            continue
        actual = tb.bucket_digest(full)
        if actual != recorded:
            _quarantine(root, full, "torn_bucket", "temporal_bucket",
                        items,
                        f"recorded {recorded[:23]}..., "
                        f"actual {actual[:23]}...")
        else:
            _VERIFIED[cache_key] = True
