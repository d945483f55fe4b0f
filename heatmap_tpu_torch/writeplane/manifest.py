"""Epoch-unified manifest over per-range delta stores.

A write-plane root is a directory of ordinary delta stores (one per
Morton range, each with its own CURRENT / base-* / delta-* / journal/)
plus a top-level **manifest**: an epoch-numbered snapshot file naming,
for every range, exactly which immutable artifact dirs a reader merges
(``base`` + live ``deltas``) and the partition plan the routers used.

    wroot/
      MANIFEST               atomic JSON pointer {schema, epoch}
      manifest-XXXXXX.json   immutable epoch snapshot (digest-stamped)
      ranges/rNNN/           one delta store root per Morton range
      ledger/                full-batch dedup journal (plane.py)
      quarantine/            torn/orphan manifests (recover.py)

The flip discipline is delta/compact.py's CURRENT contract verbatim:
the snapshot file is staged ``.tmp`` + fsync + ``os.replace`` + parent
fsync, then the MANIFEST pointer flips the same way. Because per-range
artifact dirs are immutable once published (appends create new
``delta-*`` dirs; compaction publishes a new ``base-*`` and only then
prunes), a snapshot stays internally consistent forever: a reader that
loaded epoch E keeps serving one coherent cross-range overlay while
writers advance — it can never observe half of epoch E and half of
E+1. Snapshot integrity is self-checked: ``digest`` is the sha256 of
the canonical JSON minus the digest field, so a torn write is detected
on read (skipped in favor of the last good epoch) and quarantined by
the sweep (writeplane/recover.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile

from heatmap_tpu_torch.utils.checkpoint import fsync_dir

MANIFEST_SCHEMA = "heatmap-tpu.writeplane.v1"
POINTER_NAME = "MANIFEST"
RANGES_DIRNAME = "ranges"
LEDGER_DIRNAME = "ledger"

_MANIFEST_RE = re.compile(r"^manifest-(\d{6})\.json$")


def manifest_name(epoch: int) -> str:
    return f"manifest-{int(epoch):06d}.json"


def manifest_path(root: str, epoch: int) -> str:
    return os.path.join(root, manifest_name(epoch))


def range_root(root: str, name: str) -> str:
    return os.path.join(root, RANGES_DIRNAME, name)


def ledger_dir(root: str) -> str:
    return os.path.join(root, LEDGER_DIRNAME)


def snapshot_digest(snap: dict) -> str:
    """sha256 over the canonical JSON of everything but ``digest``."""
    body = {k: v for k, v in snap.items() if k != "digest"}
    return "sha256:" + hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()


def _write_json_atomic(root: str, final: str, payload: dict):
    """tmp + fsync + os.replace + parent fsync (the CURRENT contract)."""
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(root, final))
        fsync_dir(root)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_snapshot(root: str, snap: dict):
    """Publish one manifest epoch: stage + flip the snapshot file, then
    flip the MANIFEST pointer to it. Both steps are individually atomic,
    so a crash leaves either the old pointer (the new snapshot file is
    unreferenced garbage the sweep quarantines) or the new pointer with
    its snapshot complete — never a torn visible epoch. Re-running the
    whole publish is idempotent (same epoch, same bytes)."""
    epoch = int(snap["epoch"])
    snap = dict(snap)
    snap["schema"] = MANIFEST_SCHEMA
    snap["digest"] = snapshot_digest(snap)
    _write_json_atomic(root, manifest_name(epoch), snap)
    _write_json_atomic(root, POINTER_NAME,
                       {"schema": MANIFEST_SCHEMA, "epoch": epoch})


def read_pointer(root: str):
    """MANIFEST's epoch, or None when absent/unreadable."""
    try:
        with open(os.path.join(root, POINTER_NAME)) as f:
            ptr = json.load(f)
        return int(ptr["epoch"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def list_epochs(root: str) -> list[int]:
    """Epochs with a snapshot file on disk, ascending (no validation)."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _MANIFEST_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def load_snapshot(root: str, epoch: int) -> dict:
    """One epoch's snapshot, digest-verified; raises ValueError on a
    torn/malformed/mismatched file (the sweep quarantines those)."""
    path = manifest_path(root, epoch)
    try:
        with open(path) as f:
            snap = json.load(f)
    except OSError as e:
        raise ValueError(f"manifest epoch {epoch}: unreadable "
                         f"({e!r})") from e
    except json.JSONDecodeError as e:
        raise ValueError(f"manifest epoch {epoch}: torn JSON "
                         f"({e!r})") from e
    if not isinstance(snap, dict):
        raise ValueError(f"manifest epoch {epoch}: not an object")
    if snap.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(f"manifest epoch {epoch}: schema "
                         f"{snap.get('schema')!r} != {MANIFEST_SCHEMA!r}")
    if int(snap.get("epoch", -1)) != int(epoch):
        raise ValueError(f"manifest epoch {epoch}: file claims epoch "
                         f"{snap.get('epoch')!r}")
    recorded = snap.get("digest")
    if recorded != snapshot_digest(snap):
        raise ValueError(f"manifest epoch {epoch}: digest mismatch "
                         f"(recorded {str(recorded)[:23]}...)")
    return snap


def read_manifest(root: str) -> dict | None:
    """The newest *valid* snapshot: the pointer's epoch when it loads
    clean, else the newest earlier epoch that does (torn-manifest
    fallback — readers serve the last good epoch; quarantining the torn
    file is the sweep's job, never the read path's). None on a root
    with no valid snapshot (an empty plane)."""
    tried = set()
    ptr = read_pointer(root)
    if ptr is not None:
        try:
            return load_snapshot(root, ptr)
        except ValueError:
            tried.add(ptr)
    for epoch in reversed(list_epochs(root)):
        if epoch in tried:
            continue
        try:
            return load_snapshot(root, epoch)
        except ValueError:
            continue
    return None


def overlay_dirs(root: str, snap: dict) -> list[str]:
    """Artifact dirs a reader merges for this snapshot, range-ordered
    (base first, then deltas oldest-first per range). Driven entirely
    by the snapshot, never by globbing — an artifact a writer published
    after this epoch is invisible until the next manifest flip."""
    dirs = []
    for name in snap.get("order", ()):
        entry = snap.get("ranges", {}).get(name, {})
        rroot = range_root(root, name)
        if entry.get("base"):
            d = os.path.join(rroot, entry["base"])
            if os.path.isdir(d):
                dirs.append(d)
        for art in entry.get("deltas", ()):
            d = os.path.join(rroot, art)
            if os.path.isdir(d):
                dirs.append(d)
    return dirs
