"""Atomic checkpoints with retention.

The port's copy of heatmap_tpu/utils/checkpoint.py (numpy only), so a
checkpoint written by either package loads in the other. The reference
has no checkpoint/resume: a 16-level Spark lineage is recomputed from
source on failure (reference heatmap.py:113-116,150).

- ``save_checkpoint`` writes arrays + JSON-serializable meta as one npz
  via write-to-temp + atomic rename, so a crash mid-write never leaves
  a truncated checkpoint behind.
- ``CheckpointManager`` numbers checkpoints by step, finds the latest,
  and prunes old ones (keep-N retention).
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np

_META_KEY = "__meta_json__"
_STEP_RE = re.compile(r"^ckpt-(\d+)\.npz$")


def fsync_dir(path: str):
    """fsync a directory so a just-renamed entry survives power loss.

    Best-effort: platforms/filesystems that refuse O_RDONLY directory
    fds (or directory fsync entirely) degrade to the pre-fsync
    behavior rather than failing the publish.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_checkpoint(path: str, arrays: dict, meta: dict | None = None):
    """Atomically write ``arrays`` (+ JSON ``meta``) to ``path`` (.npz):
    write-to-temp, fsync, ``os.replace``, parent-dir fsync."""
    for k in arrays:
        if k == _META_KEY:
            raise ValueError(f"array name {k!r} is reserved")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload[_META_KEY] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """-> (arrays, meta)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode()) \
            if _META_KEY in z.files else {}
    return arrays, meta


class CheckpointManager:
    """Step-numbered checkpoints in a directory, keep-N retention."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.npz")

    def steps(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            # Directory removed by a concurrent maintenance pass —
            # same answer as an empty directory.
            return []
        out = []
        for name in names:
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, arrays: dict, meta: dict | None = None) -> str:
        meta = dict(meta or {})
        meta["step"] = step
        path = self._path(step)
        save_checkpoint(path, arrays, meta)
        self._prune()
        return path

    def load(self, step: int | None = None) -> tuple[dict, dict]:
        """Load ``step`` (default: latest). Raises FileNotFoundError if
        there is nothing to load."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}"
                )
        return load_checkpoint(self._path(step))

    def prune(self, keep: int | None = None):
        """Delete all but the newest ``keep`` checkpoints (default:
        the manager's retention).

        Robust to a concurrent maintenance pass racing us: a file that
        vanishes between the listing and the unlink is somebody else's
        successful deletion, not a failure — skip it and keep pruning
        the rest. ``keep=0`` deletes everything (the delta journal's
        retention pass uses this once every entry has been folded into
        a compacted base).
        """
        keep = self.keep if keep is None else keep
        if keep < 0:
            raise ValueError("keep must be >= 0")
        steps = self.steps()
        doomed = steps[:-keep] if keep else steps
        for s in doomed:
            try:
                os.unlink(self._path(s))
            except FileNotFoundError:
                continue  # concurrently deleted — keep pruning
            except OSError:
                continue

    def _prune(self):
        self.prune()
