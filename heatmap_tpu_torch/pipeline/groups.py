"""User-group routing: the reference's per-user heatmap rules.

A copy of heatmap_tpu/pipeline/groups.py for the PyTorch port.

Reference heatmap.py:64-70 semantics, reproduced exactly:

- every point counts toward the ``'all'`` group;
- user ids starting with ``'x'`` are excluded from per-user heatmaps
  (they still count in ``'all'``);
- user ids starting with ``'rt-'`` are pooled under ``"route"``;
- everyone else gets their own per-user group.

Strings stay on the host; devices see dense int32 group ids
(``ALL_GROUP == 0``; excluded points get ``EXCLUDED``).
"""

from __future__ import annotations

import numpy as np

ALL_GROUP = 0
EXCLUDED = -1

ALL_NAME = "all"
ROUTE_NAME = "route"


def route_user(user_id: str):
    """Routed per-user group name, or None if excluded (x-prefix).

    Mirrors reference heatmap.py:65-70 (prefix tests via slicing, so a
    bare ``"x"`` or ``"rt-"`` id behaves identically to the reference).
    """
    if user_id[:1] == "x":
        return None
    if user_id[:3] == "rt-":
        return ROUTE_NAME
    return user_id


class UserVocab:
    """Host-side bidirectional map: routed group name <-> dense int id.

    Group 0 is always ``'all'``. Built incrementally so streaming
    micro-batches can extend it.
    """

    def __init__(self):
        self._names = [ALL_NAME]
        self._ids = {ALL_NAME: ALL_GROUP}

    def __len__(self):
        return len(self._names)

    @property
    def names(self):
        return tuple(self._names)

    def id_for(self, group_name: str) -> int:
        gid = self._ids.get(group_name)
        if gid is None:
            gid = len(self._names)
            self._names.append(group_name)
            self._ids[group_name] = gid
        return gid

    def name_for(self, gid: int) -> str:
        return self._names[gid]

    def group_ids(self, user_ids) -> np.ndarray:
        """Per-point routed group id (EXCLUDED for x-users).

        Factorize-then-route-unique: one hash factorize over the id
        column, then Python routing only per DISTINCT user — instead of
        the reference's per-record mapper cost (heatmap.py:64-70) on
        every row (measured ~4x on 10M rows). Factorize preserves
        first-appearance order, so vocab ids are assigned in first-use
        row order — identical to the per-row loop (and to
        run_job_fast's reader-table mapping, which mirrors that order).
        """
        n = len(user_ids)
        if n == 0:
            return np.empty(0, np.int32)
        codes = uniques = None
        try:
            import pandas as pd

            codes, uniques = pd.factorize(
                np.asarray(user_ids, dtype=object), use_na_sentinel=False
            )
        except (ImportError, TypeError):
            # No pandas, or pandas < 1.5 (kwarg spelled na_sentinel) —
            # degrade to the loop rather than fail the whole ingest.
            # Only the factorize call sits in this try: routing errors
            # below (e.g. a None user id) must stay loud.
            pass
        if codes is not None:
            mapped = np.empty(len(uniques), np.int32)
            for j, uid in enumerate(uniques):
                # Route the ORIGINAL object: None/int ids must fail as
                # loudly as they do in the per-row loop, not be
                # stringified into a bogus 'nan'/'123' group.
                name = route_user(uid)
                mapped[j] = EXCLUDED if name is None else self.id_for(name)
            return mapped[codes].astype(np.int32)
        # Dict-cache loop: one hash lookup per row, routing only on
        # first sight of each id.
        cache: dict = {}
        out = np.empty(n, np.int32)
        for i, uid in enumerate(user_ids):
            gid = cache.get(uid)
            if gid is None:
                name = route_user(uid)
                gid = EXCLUDED if name is None else self.id_for(name)
                cache[uid] = gid
            out[i] = gid
        return out
