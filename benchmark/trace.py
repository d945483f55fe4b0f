"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The traced window is one ``benchmark.window`` annotation on the host.
Device activity is every kernel, copy and memset of the profiler's
timeline; the busy time is the length of their union inside the window,
per card, averaged over the cards. An idle gap is a stretch of the
window with no device activity, named after what the host was doing in
its middle: the innermost profiled host event there (an operator, a CUDA
runtime call or an annotation), or ``host`` where none was open.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

import numpy as np

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def profiled(device, sink: dict):
    """Profile the body (CPU and, on a card, CUDA activity) inside one
    ``benchmark.window`` annotation; on exit ``sink["trace"]`` holds the
    parsed :class:`Trace`. The chrome trace passes through one temporary
    file, deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="benchmark-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            sink["trace"] = Trace(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80]


def global_functions(cu_source: str) -> set:
    """Names of the ``__global__`` functions of a CUDA source."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")
    return set(pat.findall(cu_source))


class Trace:
    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("trace has no benchmark.window annotation")
        w = win[0]
        self.start = float(w["ts"])
        self.end = self.start + float(w["dur"])
        self.device = []
        self.host = []
        self._corr = {}
        self._runtime = []
        self._ops = {}
        for e in xs:
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e["dur"])
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                dev = args.get("device", 0)
                self.device.append((ts, ts + dur, cat, e["name"], dev))
                if "correlation" in args:
                    self._corr.setdefault(args["correlation"], []).append(
                        len(self.device) - 1)
            elif cat in HOST_CATS and e is not w:
                self.host.append((ts, ts + dur, e["name"]))
                if cat in ("cuda_runtime", "cuda_driver"):
                    self._runtime.append((ts, ts + dur, e.get("tid"),
                                          args.get("correlation")))
                elif cat == "cpu_op":
                    self._ops.setdefault(e.get("tid"), []).append(
                        (ts, ts + dur))
        self.host.sort()
        self._runtime.sort(key=lambda r: r[0])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def _busy_intervals(self, dev):
        ivs = sorted((max(a, self.start), min(b, self.end))
                     for a, b, _, _, d in self.device if d == dev)
        merged = []
        for a, b in ivs:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def devices(self):
        return sorted({d for *_, d in self.device})

    def busy_s(self) -> float:
        """Seconds with a device operation running, averaged over the
        cards that ran any."""
        devs = self.devices()
        if not devs:
            return 0.0
        return sum(sum(b - a for a, b in self._busy_intervals(d))
                   for d in devs) / len(devs) / 1e6

    def op_time(self, names: set):
        """``(seconds, calls)`` of the device work of a kernel wrapper
        that launches from C (through ctypes) rather than from a PyTorch
        operator: a call is a run of CUDA runtime calls made outside any
        profiled operator, one of whose kernels is in ``names``, and its
        time is that of every kernel, copy and memset the run launched
        (the memsets that zero its outputs too)."""
        inside = {}
        for tid, ivs in self._ops.items():
            merged = []
            for a, b in sorted(ivs):
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            inside[tid] = (np.array([m[0] for m in merged]),
                           np.array([m[1] for m in merged]))

        def enclosed(ts, tid):
            starts, ends = inside.get(tid, (np.array([]), np.array([])))
            i = int(np.searchsorted(starts, ts, side="right")) - 1
            return i >= 0 and ts <= ends[i]

        groups, cur = [], []
        for ts, _, tid, corr in self._runtime:
            if enclosed(ts, tid):
                if cur:
                    groups.append(cur)
                    cur = []
            elif corr is not None:
                cur.append(corr)
        if cur:
            groups.append(cur)
        total, calls = 0.0, 0
        for g in groups:
            evs = [self.device[k] for c in g for k in self._corr.get(c, ())]
            if any(cat == "kernel" and short_name(n).split("::")[-1] in names
                   for _, _, cat, n, _ in evs):
                total += sum(b - a for a, b, *_ in evs)
                calls += 1
        return total / 1e6, calls

    def copy_time(self, kind: str) -> float:
        """Seconds of the copies whose name holds ``kind`` (``HtoD``)."""
        return sum(b - a for a, b, cat, name, _ in self.device
                   if cat == "gpu_memcpy" and kind in name) / 1e6

    def device_ops(self, top: int = 10):
        """The device operations that took most time: ``[name, s]``."""
        acc = {}
        for a, b, cat, name, _ in self.device:
            key = short_name(name) if cat == "kernel" else name
            acc[key] = acc.get(key, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """Idle seconds inside the window by what the host was doing:
        ``[name, s]``, longest first."""
        devs = self.devices()
        busy = self._busy_intervals(devs[0]) if devs else []
        gaps, t = [], self.start
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.end:
            gaps.append((t, self.end))
        starts = np.array([h[0] for h in self.host])
        acc = {}
        for a, b in gaps:
            acc_key = self._host_at((a + b) / 2, starts)
            acc[acc_key] = acc.get(acc_key, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:top]

    def _host_at(self, t: float, starts) -> str:
        """The last-opened profiled host event still open at ``t``: with
        nested events, the innermost."""
        i = int(np.searchsorted(starts, t, side="right")) - 1
        for j in range(i, max(i - 500, -1), -1):
            a, b, name = self.host[j]
            if b >= t:
                return name
        return "host"
