"""Whole batch jobs with dated timespans, back to back, over sources held in
host memory.

The jobs of :mod:`benchmark.drivers.batch_jobs` over tables of dated
trajectories (:mod:`benchmark.generate_dated`), with the configuration's
``timespans`` (alltime, year, month, day): every point emits once per
timespan for ``all`` and once for its user. The check holds the blob
dict of the last job, and of one earlier job's drawn from the seed, to
the dated reference's (:mod:`benchmark.reference.timespans`): every
blob id, and every blob's bytes. The traced run also reports the
program's counters of its last cascade, its slots and its key width,
and the resolved backend with its launches a job.
"""

from __future__ import annotations

import json
import sys

from benchmark import generate_dated
from benchmark.drivers import batch_jobs
from benchmark.reference import timespans as ref_timespans


#: UTC offset, in hours, of Beijing's local time: the labels of the
#: control that reads local time.
LOCAL_OFFSET_H = 8


class Driver(batch_jobs.Driver):
    def setup(self):
        from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

        self.mark("imports")
        job = self.job = dict(self.config["job"])
        job["levels"] = job["detail_zoom"] - job["min_detail_zoom"]
        n = int(self.config["points_per_job"])
        self.tables = [
            generate_dated.dated_table(n, self.config, self.seed,
                                       f"dated-table-{j}", self.device)
            for j in range(int(self.traffic["distinct_tables"]))]
        self.job_config = BatchJobConfig(
            detail_zoom=job["detail_zoom"],
            min_detail_zoom=job["min_detail_zoom"],
            result_delta=job["result_delta"],
            timespans=tuple(job["timespans"]),
        )
        kept_rows = n - int(round(n * self.config["background_share"]))
        self.counters.update(
            points_per_unit=n,
            segment_keys=2 * len(job["timespans"]) * kept_rows)
        self._ref = {}
        self.mark("inputs")
        for j in range(int(self.traffic["warmup_jobs"])):
            self._job(j)
        self.mark("warm-up")

    def instrumented(self):
        from heatmap_tpu_torch.ops import sparse_partitioned
        from heatmap_tpu_torch.pipeline import cascade

        seg = sparse_partitioned.aggregate_sorted_keys_partitioned
        before, units = seg.launches, int(self.traffic["timed_units"])
        out = super().instrumented()
        counters = {
            "resolved_backend":
                self.job_config.resolved_cascade_backend(self.device),
            "segment_launches_per_job": (seg.launches - before) / units,
            "key_bits": getattr(cascade.build_cascade, "key_bits", None),
            "n_slots": getattr(cascade.build_cascade, "n_slots", None),
        }
        print("program counters: " + json.dumps(counters), file=sys.stderr)
        out["program_counters"] = counters
        return out

    def _levels(self, j: int, precision: str, utc_offset_h: int = 0):
        key = (j, precision, utc_offset_h)
        if key not in self._ref:
            self._ref[key] = ref_timespans.level_counts(
                self.tables[j], self.job, precision, utc_offset_h)
        return self._ref[key]

    def _reference(self, i: int, precision: str, utc_offset_h: int = 0):
        names, levels = self._levels(i % len(self.tables), precision,
                                     utc_offset_h)
        return ref_timespans.blobs(names, levels, self.job)

    def _compare(self, answers) -> list:
        off = 0
        for i, got in answers:
            want = self._reference(i, self.config["projection"])
            bad = sum(1 for k, v in want.items() if got.get(k) != v)
            bad += sum(1 for k in got if k not in want)
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
        return [("blobs_off", off, self.limit("blobs_off"))]

    def control(self):
        """The float32 control, and a second one: the reference's labels
        from Beijing's local time (UTC+8) instead of UTC."""
        out = []
        for name, precision, offset in (
                ("blobs_off", "float32", 0),
                ("blobs_off.local_time", self.config["projection"],
                 LOCAL_OFFSET_H)):
            self.failed = 0
            answers = [(i, self._reference(i, precision, offset))
                       for i, _ in self.answers]
            ((_, off, limit),) = self._compare(answers)
            out.append((name, off, limit))
        return out
