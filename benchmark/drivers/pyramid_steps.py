"""Whole-pyramid steps over points that sit on the card.

Each step is ``heatmap_tpu_torch.bench.step`` over the configuration's
``points_per_step`` points: it projects them, bins them into the
configuration's window and rolls the dense pyramid up ``levels`` times;
``.item()`` of the top-level sum ends it.
The steps cycle through ``distinct_inputs`` point sets made on the card
from the seed. The check holds every level of the last step's pyramid,
and of one earlier step's drawn from the seed, to the reference's, cell
by cell.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import drivers, generate
from benchmark.reference import raster as ref_raster
from benchmark.reference import tiles as ref_tiles

DTYPES = {"float64": torch.float64, "float32": torch.float32}


class Driver(drivers.Driver):
    def setup(self):
        from heatmap_tpu_torch.ops.histogram import window_from_bounds

        self.mark("imports")
        w = self.config["window"]
        self.window = window_from_bounds(
            tuple(w["lat"]), tuple(w["lon"]), w["zoom"],
            align_levels=w["align_levels"], pad_multiple=w["pad_multiple"])
        n = int(self.config["points_per_step"])
        self.inputs = [
            generate.mixture_points(n, self.config["points"], self.seed,
                                    f"step-input-{i}", self.device)
            for i in range(int(self.traffic["distinct_inputs"]))]
        self.proj = DTYPES[self.config["projection"]]
        self.counters.update(points_per_unit=n, bucketed_points=n,
                             window_cells=self.window.height * self.window.width)
        self.mark("inputs")
        for i in range(len(self.inputs)):
            self._step(i)
        self.mark("warm-up")

    def _step(self, i: int):
        from heatmap_tpu_torch import bench

        lat, lon = self.inputs[i % len(self.inputs)]
        total, pyr = bench.step(lat, lon, self.window, self.config["levels"],
                                self.config["bin_backend"],
                                proj_dtype=self.proj)
        total.item()
        return pyr

    def unit(self):
        i = self.n_units
        self.keeper.add(i, self._step(i))
        self.n_units += 1

    def program_counters(self):
        from heatmap_tpu_torch.ops import partitioned

        return {"bucketed_calls":
                partitioned.bin_rowcol_window_partitioned.launches}

    def instrumented(self):
        if self.device.type != "cuda":
            return {}
        from benchmark.split import split_step

        out = {}
        for k in range(int(self.traffic["split_steps"])):
            lat, lon = self.inputs[k % len(self.inputs)]
            ms, _ = split_step(lat, lon, self.window, self.config["levels"],
                               self.config["bin_backend"], self.proj)
            for stage, v in ms.items():
                out.setdefault(stage, []).append(v)
        return {"split_ms": out}

    def release(self):
        kept = self.keeper.kept()
        used = {i % len(self.inputs) for i, _ in kept}
        self.host_inputs = {j: tuple(x.cpu().numpy() for x in self.inputs[j])
                            for j in used}
        self.answers = [(i, [lvl.cpu().numpy() for lvl in pyr])
                        for i, pyr in kept]
        self.keeper = None
        del self.inputs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, j: int, precision: str):
        w = self.config["window"]
        win = ref_tiles.window(w["lat"], w["lon"], w["zoom"],
                               w["align_levels"], w["pad_multiple"])
        lat, lon = self.host_inputs[j]
        return ref_raster.pyramid(
            ref_raster.bin_window(lat, lon, w["zoom"], win, precision),
            self.config["levels"])

    def _compare(self, answers) -> list:
        want = {}
        off = 0
        for i, pyr in answers:
            j = i % int(self.traffic["distinct_inputs"])
            if j not in want:
                want[j] = self._reference(j, self.config["projection"])
            bad = _cells_off(pyr, want[j])
            off += bad
            self.failed += bad > 0
        return [("cells_off", off, self.limit("cells_off"))]

    def check(self):
        return self._compare(self.answers)

    def control(self):
        low = "float32"
        self.failed = 0
        answers = [(i, self._reference(i % int(self.traffic["distinct_inputs"]),
                                       low)) for i, _ in self.answers]
        return self._compare(answers)


def _cells_off(got, want) -> int:
    """Cells of every level that differ; a level of the wrong shape, or
    missing, counts all its cells."""
    off = 0
    for k, w in enumerate(want):
        g = got[k] if k < len(got) else None
        if g is None or g.shape != w.shape:
            off += w.size
        else:
            off += int(np.count_nonzero(g.astype(np.int64) != w))
    off += sum(g.size for g in got[len(want):])
    return off
