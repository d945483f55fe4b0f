"""Whole batch jobs, back to back, over sources held in host memory.

Each job is ``run_job(source, config=BatchJobConfig(...),
max_points_in_flight=0, device=...)`` over one of ``distinct_tables``
tables of GPS rows made from the seed, and ends when the
``{blob_id: json}`` dict is back. The check holds the blob dict of the
last job, and of one earlier job's drawn from the seed, to the
reference's: every blob id, and every blob's bytes.
"""

from __future__ import annotations

import torch

from benchmark import drivers, generate
from benchmark.reference import batch as ref_batch


class Driver(drivers.Driver):
    def setup(self):
        from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

        self.mark("imports")
        job = self.job = dict(self.config["job"])
        job["levels"] = job["detail_zoom"] - job["min_detail_zoom"]
        n = int(self.config["points_per_job"])
        self.tables = [
            generate.gps_table(n, self.config, self.seed, f"job-table-{j}",
                               self.device)
            for j in range(int(self.traffic["distinct_tables"]))]
        self.job_config = BatchJobConfig(
            detail_zoom=job["detail_zoom"],
            min_detail_zoom=job["min_detail_zoom"],
            result_delta=job["result_delta"],
            timespans=(job["timespan"],),
        )
        kept_rows = n - int(round(n * self.config["background_share"]))
        self.counters.update(points_per_unit=n, segment_keys=2 * kept_rows)
        self._ref = {}
        self.mark("inputs")
        for j in range(int(self.traffic["warmup_jobs"])):
            self._job(j)
        self.mark("warm-up")

    def _job(self, i: int, timer=None):
        from heatmap_tpu_torch.pipeline.batch import run_job

        table = self.tables[i % len(self.tables)]
        return run_job(generate.TableSource(table), config=self.job_config,
                       batch_size=int(self.traffic["batch_size"]),
                       max_points_in_flight=0, device=self.device,
                       timer=timer)

    def unit(self):
        i = self.n_units
        self.keeper.add(i, self._job(i))
        self.n_units += 1

    def program_counters(self):
        from heatmap_tpu_torch.ops import sparse_partitioned

        return {"segment_launches":
                sparse_partitioned.aggregate_sorted_keys_partitioned.launches}

    def instrumented(self):
        from heatmap_tpu_torch.devices import StageTimer

        stage_ms = {}
        for _ in range(int(self.traffic["timed_units"])):
            timer = StageTimer(self.device)
            self._job(self.n_units, timer=timer)
            self.n_units += 1
            for name, v in timer.ms.items():
                stage_ms.setdefault(name, []).append(sum(v))
        return {"stage_ms": stage_ms}

    def release(self):
        self.answers = self.keeper.kept()
        self.keeper = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _levels(self, j: int, precision: str):
        key = (j, precision)
        if key not in self._ref:
            self._ref[key] = ref_batch.level_counts(
                self.tables[j], self.job, precision)
        return self._ref[key]

    def _compare(self, answers) -> list:
        off = 0
        for i, got in answers:
            names, levels = self._levels(i % len(self.tables),
                                         self.config["projection"])
            want = ref_batch.blobs(names, levels, self.job)
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

    def check(self):
        return self._compare(self.answers)

    def control(self):
        self.failed = 0
        answers = []
        for i, _ in self.answers:
            names, levels = self._levels(i % len(self.tables), "float32")
            answers.append((i, ref_batch.blobs(names, levels, self.job)))
        return self._compare(answers)
