"""Whole batch jobs into columnar level arrays, back to back, over sources
held in host memory.

The jobs of :mod:`benchmark.drivers.batch_jobs`, each into a sink that
has ``write_levels``: ``run_job`` then finalizes the decoded levels and
hands them to the sink instead of formatting JSON blobs (the port's
npz, Parquet and tilefs sinks take this path). The sink here keeps each
level's columns and name tables in memory: no JSON, no disk. The check
holds the levels of the last job, and of one earlier job's drawn from
the seed, to the reference's counts (:func:`benchmark.reference.batch.
level_counts`): every row of (user, timespan, zoom, row, col, value)
missing, extra or different counts.
"""

from __future__ import annotations

import numpy as np

from benchmark import generate
from benchmark.drivers import batch_jobs
from benchmark.reference import batch as ref_batch
from benchmark.reference.tiles import z_order

class LevelsSink:
    """A columnar sink in memory: ``write_levels`` keeps each finalized
    level's columns (those the port's ``LevelArraysSink`` writes), zoom
    and name tables."""

    def __init__(self):
        self.levels = []

    def write_levels(self, levels) -> int:
        from heatmap_tpu_torch.io.sinks import LevelArraysSink

        for lvl in levels:
            kept = {k: np.asarray(lvl[k]) for k in LevelArraysSink.COLUMNS}
            kept["zoom"] = int(lvl["zoom"])
            kept["user_names"] = np.asarray(lvl["user_names"])
            kept["timespan_names"] = np.asarray(lvl["timespan_names"])
            self.levels.append(kept)
        return sum(len(lvl["value"]) for lvl in self.levels)


def reference_levels(names, levels, timespan: str) -> list:
    """The reference's counts in the sink's form."""
    out = []
    for z, keys, cnt in levels:
        g = keys >> (2 * z)
        code = keys & ((1 << (2 * z)) - 1)
        out.append({"zoom": z, "row": ref_batch._unspread(code >> 1),
                    "col": ref_batch._unspread(code),
                    "value": cnt.astype(np.float64), "user_idx": g,
                    "timespan_idx": np.zeros(len(g), np.int64),
                    "user_names": np.asarray(names),
                    "timespan_names": np.asarray([timespan])})
    return out


def levels_off(got: list, names, want_levels, timespan: str) -> int:
    """Rows of ``got`` (the sink's levels) missing from, extra to or
    different from the reference's ``(zoom, keys, counts)``: a row is
    keyed by its user's group in ``names``, its zoom, row and column, and
    compared by its value; a row of another timespan or of an unknown
    user counts as extra."""
    gid = {g: i for i, g in enumerate(names)}
    by_zoom = {}
    off = 0
    for lvl in got:
        to_gid = np.array([gid.get(u, -1) for u in
                           lvl["user_names"].tolist()], np.int64)
        g = to_gid[lvl["user_idx"]]
        ok = (g >= 0) & (lvl["timespan_names"] == timespan)[
            lvl["timespan_idx"]]
        off += int((~ok).sum())
        z = lvl["zoom"]
        keys = (g[ok] << (2 * z)) | z_order(lvl["row"][ok], lvl["col"][ok])
        prev = by_zoom.get(z)
        value = lvl["value"][ok]
        if prev is not None:
            keys = np.concatenate([prev[0], keys])
            value = np.concatenate([prev[1], value])
        by_zoom[z] = (keys, value)
    for z, keys, cnt in want_levels:
        gk, gv = by_zoom.pop(z, (np.empty(0, np.int64), np.empty(0)))
        order = np.argsort(gk, kind="stable")
        gk, gv = gk[order], gv[order]
        uk, first, dup = np.unique(gk, return_index=True, return_counts=True)
        off += int((dup - 1).sum())
        common, gi, wi = np.intersect1d(uk, keys, assume_unique=True,
                                        return_indices=True)
        off += len(uk) - len(common) + len(keys) - len(common)
        off += int((gv[first[gi]] != cnt[wi]).sum())
    off += sum(len(k) for k, _ in by_zoom.values())
    return off


class Driver(batch_jobs.Driver):
    def _job(self, i: int, timer=None):
        from heatmap_tpu_torch.pipeline.batch import run_job

        table = self.tables[i % len(self.tables)]
        sink = LevelsSink()
        run_job(generate.TableSource(table), sink=sink,
                config=self.job_config,
                batch_size=int(self.traffic["batch_size"]),
                max_points_in_flight=0, device=self.device, timer=timer)
        return sink.levels

    def _compare(self, answers) -> list:
        off = 0
        for i, got in answers:
            names, levels = self._levels(i % len(self.tables),
                                         self.config["projection"])
            bad = levels_off(got, names, levels, self.job["timespan"])
            off += bad
            self.failed += bad > 0
        if self.traced is not None:
            io = []
            for i in range(*self.traced):
                _, levels = self._levels(i % len(self.tables),
                                         self.config["projection"])
                io.extend((self.counters["segment_keys"], len(keys))
                          for _, keys, _ in levels)
            self.counters["segment_io"] = io
        return [("levels_off", off, self.limit("levels_off"))]

    def control(self):
        self.failed = 0
        answers = []
        for i, _ in self.answers:
            names, levels = self._levels(i % len(self.tables), "float32")
            answers.append((i, reference_levels(names, levels,
                                                self.job["timespan"])))
        return self._compare(answers)
