"""Append-only ingest journal: content-hashed, epoch-numbered batches.

The port's copy of heatmap_tpu/delta/journal.py: for the same point
columns the content hash, the entry digest and the entry files are the
JAX package's, so a store journaled by either package continues in the
other and a batch journaled by one is a duplicate in the other.

Every accepted batch is one journal entry — an empty-array checkpoint
written through ``utils/checkpoint.save_checkpoint`` (the atomic
tmp-write + rename contract) whose JSON meta carries the batch's
content hash, point count, timestamp watermark, monotonic epoch and
sign (+1 insert, -1 retraction). This extends the checkpoint module's
recovery model from "resume a partial cascade" to "replay-proof
ingest": re-submitting an already-journaled batch finds its hash and
is a no-op, so an at-least-once upstream (a retried queue consumer, a
re-run cron) converges to exactly-once pyramid updates.

The files are ``ckpt-<epoch>.npz`` under the journal directory —
``CheckpointManager``'s own naming — so epoch listing, latest-epoch
and the retention prune are all the manager's hardened code paths,
not a parallel implementation.

Idempotency is scoped to the retention window: once a compaction has
folded an entry into the base AND the retention pass has pruned it,
its hash is forgotten and a re-submit would double-count. Size the
retention window to cover the upstream's maximum redelivery horizon.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np

from heatmap_tpu_torch import faults
from heatmap_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint

#: Columns hashed (when present) to derive a batch identity. Floats are
#: hashed as raw little-endian f64 bytes, strings NUL-joined — the hash
#: is a pure function of the point data, independent of batch chunking.
HASH_FLOAT_COLUMNS = ("latitude", "longitude", "value")
HASH_OBJECT_COLUMNS = ("user_id", "source", "timestamp")


def batch_content_hash(cols: dict, sign: int = 1,
                       salt: str | None = None) -> str:
    """Deterministic identity of a point batch (+ its sign).

    The sign participates so that retracting a batch is a different
    journal entry from inserting it — submitting both is the intended
    way to express a correction, not a duplicate. ``salt`` extends the
    identity for callers whose batches differ by something outside the
    point columns — predicate retraction salts with the overridden
    watermark, so cancelling identical rows out of two different
    temporal buckets is two entries, not one dedup'd no-op.
    """
    h = hashlib.sha256()
    h.update(f"sign={int(sign)}".encode())
    if salt is not None:
        h.update(f"salt={salt}".encode())
    for name in HASH_FLOAT_COLUMNS:
        if name in cols:
            arr = np.ascontiguousarray(np.asarray(cols[name], np.float64))
            h.update(name.encode())
            h.update(arr.tobytes())
    for name in HASH_OBJECT_COLUMNS:
        if name in cols and len(cols[name]):
            h.update(name.encode())
            h.update("\x00".join(str(v) for v in cols[name]).encode())
    return "sha256:" + h.hexdigest()


def entry_digest(root: str, *, content_hash: str, sign: int, points: int,
                 artifact: str) -> str:
    """Integrity digest binding a journal entry to its artifact bytes.

    Hashes the entry's identity fields plus every file in the artifact
    directory (sorted by name), so a torn artifact write, a swapped
    artifact, or a tampered ``content_hash`` in the entry meta all
    produce a digest mismatch the recovery sweep (delta/recover.py)
    quarantines. Stored in the entry meta as ``entry_digest``; entries
    from stores predating the field skip verification (legacy).
    """
    h = hashlib.sha256()
    h.update(f"{content_hash}|{int(sign)}|{int(points)}|{artifact}".encode())
    d = os.path.join(root, artifact)
    if os.path.isdir(d):
        for name in sorted(os.listdir(d)):
            full = os.path.join(d, name)
            if not os.path.isfile(full):
                continue
            h.update(name.encode())
            with open(full, "rb") as f:
                h.update(f.read())
    return "sha256:" + h.hexdigest()


#: Journal-payload encoding of point columns (delta retraction's scan
#: substrate). Floats stay raw f64 (exact); everything else is stored
#: as ``str(v)`` — identical to how batch_content_hash consumes it, and
#: exact under ``float()`` round-trip for numeric timestamps — with
#: ``str(None)`` decoding back to None.
_PAYLOAD_FLOAT = ("latitude", "longitude", "value")
_PAYLOAD_STR = ("user_id", "source", "timestamp")
_NONE_TOKEN = str(None)


def encode_points(cols: dict) -> dict:
    """Point columns -> npz-safe arrays (``pt_``-prefixed, no object
    dtypes, no pickle)."""
    arrays = {}
    for name in _PAYLOAD_FLOAT:
        if name in cols:
            arrays["pt_" + name] = np.asarray(cols[name], np.float64)
    for name in _PAYLOAD_STR:
        if name in cols:
            arrays["pt_" + name] = np.asarray(
                [_NONE_TOKEN if v is None else str(v)
                 for v in cols[name]])
    return arrays


def decode_points(arrays: dict) -> dict | None:
    """Inverse of :func:`encode_points`; None for a legacy entry that
    predates point payloads (retraction cannot scan it)."""
    cols: dict = {}
    for name in _PAYLOAD_FLOAT:
        key = "pt_" + name
        if key in arrays:
            cols[name] = np.asarray(arrays[key], np.float64)
    for name in _PAYLOAD_STR:
        key = "pt_" + name
        if key in arrays:
            cols[name] = [None if v == _NONE_TOKEN else v
                          for v in np.asarray(arrays[key], str).tolist()]
    return cols or None


class DeltaJournal:
    """Epoch-numbered journal entries in a directory.

    Appends never prune (``save_checkpoint`` is called directly, not
    ``CheckpointManager.save`` — the manager's keep-N would eat live
    entries); retention is an explicit post-compaction pass.
    """

    def __init__(self, directory: str):
        self._mgr = CheckpointManager(directory, keep=1)

    @property
    def directory(self) -> str:
        return self._mgr.directory

    def epochs(self) -> list[int]:
        return self._mgr.steps()

    def latest_epoch(self) -> int:
        return self._mgr.latest_step() or 0

    def next_epoch(self) -> int:
        return self.latest_epoch() + 1

    def entries(self) -> list[dict]:
        """All journal entry metas, oldest epoch first. An entry pruned
        between the listing and the read is skipped (same concurrent-
        maintenance stance as CheckpointManager.prune)."""
        out = []
        for epoch in self.epochs():
            try:
                _, meta = self._mgr.load(epoch)
            except FileNotFoundError:
                continue
            out.append(meta)
        return out

    def find(self, content_hash: str) -> dict | None:
        for meta in self.entries():
            if meta.get("content_hash") == content_hash:
                return meta
        return None

    def load_points(self, epoch: int) -> dict | None:
        """The point columns journaled with ``epoch`` (retraction's
        scan input), or None for a legacy entry without a payload."""
        arrays, _meta = self._mgr.load(int(epoch))
        return decode_points(arrays)

    def append(self, *, content_hash: str, points: int, sign: int,
               artifact: str, watermark: float | None = None,
               cols: dict | None = None) -> dict:
        """Record an accepted batch; returns the existing entry
        unchanged if the hash is already journaled (idempotent).

        ``cols`` (the batch's point columns) are stored in the entry's
        npz arrays — the extension point the empty-arrays checkpoint
        always reserved — so predicate retraction can reconstruct
        exact counter-batches by scanning retained entries
        (delta/retract.py). A torn payload fails the entry's npz load
        and is quarantined by the recovery sweep like any torn entry.
        """
        existing = self.find(content_hash)
        if existing is not None:
            return existing
        epoch = self.next_epoch()
        root = os.path.dirname(os.path.abspath(self.directory))
        meta = {
            "epoch": epoch,
            "content_hash": content_hash,
            "points": int(points),
            "sign": int(sign),
            "artifact": artifact,
            "watermark": watermark,
            "ts": time.time(),
            "entry_digest": entry_digest(root, content_hash=content_hash,
                                         sign=sign, points=points,
                                         artifact=artifact),
        }
        # save_checkpoint is atomic, so a retried append (real transient
        # or injected journal.append fault) lands the entry exactly once.
        arrays = encode_points(cols) if cols else {}
        faults.retry_call(save_checkpoint, self._mgr._path(epoch), arrays,
                          meta, site="journal.append")
        return meta

    def prune(self, *, applied_through: int, retention: int) -> list[dict]:
        """Drop entries already folded into a compacted base, keeping
        the newest ``retention`` of them as the idempotency window.
        Live entries (epoch > ``applied_through``) are always kept.
        Returns the pruned entries (the caller owns their artifacts).
        """
        if retention < 0:
            raise ValueError("retention must be >= 0")
        entries = self.entries()
        applied = [e for e in entries if e["epoch"] <= applied_through]
        doomed = applied[:-retention] if retention else applied
        # Entries are epoch-ordered and live ones are the newest, so
        # "keep all but the oldest len(doomed)" is exactly the
        # manager's hardened keep-N prune.
        self._mgr.prune(keep=len(entries) - len(doomed))
        return doomed
