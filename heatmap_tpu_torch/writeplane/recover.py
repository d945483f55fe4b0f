"""Crash recovery for a write-plane root.

Extends the delta store's sweep taxonomy (delta/recover.py) one level
up: the plane's own garbage is torn or orphaned *manifests* and torn
*ledger* entries, and every range store underneath gets the ordinary
per-root sweep. Same stance throughout: quarantine (move under
``wroot/quarantine/``), never delete — an operator inspects what a
crash or a chaos storm left behind.

Taxonomy:

- ``orphan_tmp`` — staging files from a crashed snapshot/pointer flip.
- ``torn_manifest`` — a ``manifest-XXXXXX.json`` that fails to load or
  whose digest mismatches its body. Readers already skip these
  (manifest.read_manifest falls back to the last good epoch); the
  sweep moves them out and repairs the MANIFEST pointer to the newest
  valid epoch so the fallback scan never runs twice.
- ``torn_ledger`` — an unreadable/malformed/digest-mismatched
  full-batch ledger entry. Its batch simply re-ledgers on replay (the
  per-range journals still dedup the sub-batches).
- ``orphan_range`` — a ``ranges/rNNN`` store referenced by **no**
  valid manifest epoch: the residue of a crash between range creation
  and the publish that would have made it real (first plan, or a
  rebalance that never flipped). Invisible to readers and writers
  alike, so it quarantines whole.

Every surviving range root then runs ``delta.recover.sweep`` — the
per-range torn-journal/orphan-artifact/torn-synopsis sweep is
unchanged by partitioning.
"""

from __future__ import annotations

import os
import re

from heatmap_tpu_torch.delta import recover as delta_recover
from heatmap_tpu_torch.delta.journal import entry_digest
from heatmap_tpu_torch.utils.checkpoint import load_checkpoint
from heatmap_tpu_torch.writeplane import manifest as manifest_mod

_LEDGER_ENTRY_RE = re.compile(r"^ckpt-(\d+)\.npz$")
_RANGE_RE = re.compile(r"^r\d{3}$")
_REQUIRED_LEDGER_META = ("epoch", "content_hash", "artifact", "sign",
                         "points")


def _ledger_fault(root: str, path: str, name: str):
    """-> (reason, detail); reason None for a valid ledger entry."""
    try:
        _, meta = load_checkpoint(path)
    except Exception as e:  # torn npz, bad zip, bad meta JSON
        return "unreadable", repr(e)
    missing = [k for k in _REQUIRED_LEDGER_META if meta.get(k) is None]
    if missing:
        return "malformed", f"missing fields {missing}"
    m = _LEDGER_ENTRY_RE.match(name)
    if m and int(meta["epoch"]) != int(m.group(1)):
        return "malformed", (f"epoch {meta['epoch']} != filename epoch "
                             f"{m.group(1)}")
    recorded = meta.get("entry_digest")
    if recorded is not None:
        actual = entry_digest(root, content_hash=meta["content_hash"],
                              sign=meta["sign"], points=meta["points"],
                              artifact=meta["artifact"])
        if actual != recorded:
            return "digest_mismatch", (
                f"recorded {recorded[:23]}..., actual {actual[:23]}...")
    return None, None


def sweep_plane(root: str) -> dict:
    """Quarantine crash garbage under a write-plane root; returns
    ``{"quarantined": [...], "ranges": {name: per-range sweep}}``
    (both empty when the plane is clean or ``root`` does not exist)."""
    items: list = []
    out = {"quarantined": items, "ranges": {}}
    if not os.path.isdir(root):
        return out

    # Orphan staging files from a crashed snapshot/pointer flip.
    for name in sorted(os.listdir(root)):
        if name.endswith(".tmp"):
            delta_recover.quarantine_item(
                root, os.path.join(root, name), "orphan_tmp", "tmp", items)

    # Torn manifests: quarantine every epoch file that fails to load
    # clean, remember the valid ones for pointer repair + liveness.
    valid_epochs: list = []
    referenced: set = set()
    for epoch in manifest_mod.list_epochs(root):
        try:
            snap = manifest_mod.load_snapshot(root, epoch)
        except ValueError as e:
            delta_recover.quarantine_item(
                root, manifest_mod.manifest_path(root, epoch),
                "torn_manifest", "manifest", items, detail=str(e))
            continue
        valid_epochs.append(epoch)
        referenced.update(snap.get("order", ()))
        referenced.update(snap.get("ranges", {}).keys())

    # Pointer repair: MANIFEST must name a valid epoch (readers fall
    # back by scanning, but the repaired pointer makes recovery a
    # one-read operation again). No valid epoch -> no pointer.
    ptr = manifest_mod.read_pointer(root)
    if valid_epochs:
        newest = max(valid_epochs)
        if ptr not in valid_epochs:
            manifest_mod._write_json_atomic(
                root, manifest_mod.POINTER_NAME,
                {"schema": manifest_mod.MANIFEST_SCHEMA, "epoch": newest})
    elif ptr is not None or os.path.exists(
            os.path.join(root, manifest_mod.POINTER_NAME)):
        delta_recover.quarantine_item(
            root, os.path.join(root, manifest_mod.POINTER_NAME),
            "torn_manifest", "manifest", items,
            detail="pointer with no valid manifest epoch")

    # Torn ledger entries.
    ldir = manifest_mod.ledger_dir(root)
    if os.path.isdir(ldir):
        for name in sorted(os.listdir(ldir)):
            if not _LEDGER_ENTRY_RE.match(name):
                continue
            path = os.path.join(ldir, name)
            reason, detail = _ledger_fault(root, path, name)
            if reason is not None:
                delta_recover.quarantine_item(
                    root, path, reason, "torn_ledger", items, detail=detail)

    # Orphan ranges (created but never published), then the per-range
    # sweep for every surviving referenced store.
    rdir = os.path.join(root, manifest_mod.RANGES_DIRNAME)
    if os.path.isdir(rdir):
        for name in sorted(os.listdir(rdir)):
            full = os.path.join(rdir, name)
            if not (os.path.isdir(full) and _RANGE_RE.match(name)):
                continue
            if name not in referenced:
                delta_recover.quarantine_item(
                    root, full, "orphan_range", "range", items,
                    detail="referenced by no valid manifest epoch")
    for name in sorted(referenced):
        rroot = manifest_mod.range_root(root, name)
        if os.path.isdir(rroot):
            out["ranges"][name] = delta_recover.sweep(rroot)
    return out
