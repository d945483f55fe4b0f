"""Pieces the port's bench tools share: the card's identity, the record
file and the span-tree digest."""

from __future__ import annotations

import json
import os
import subprocess
from collections import defaultdict

#: Where a tool writes its record unless ``--out`` names a file.
DEFAULT_OUT_DIR = os.path.join("build", "torch_bench")


def default_out(name: str) -> str:
    return os.path.join(DEFAULT_OUT_DIR, f"{name}.json")


def device_fields(device) -> dict:
    """``{"device": "cuda"|"cpu"}``, plus on a card its name
    (``gpu_name``) and power limit in watts (``power_limit_w``, as
    ``nvidia-smi --query-gpu=power.limit`` reads it; None where
    nvidia-smi cannot be run)."""
    import torch

    dev = torch.device(device)
    out = {"device": dev.type}
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        out["gpu_name"] = torch.cuda.get_device_name(index)
        try:
            smi = subprocess.run(
                ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, check=True, timeout=60)
            out["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
        except (OSError, subprocess.SubprocessError, ValueError,
                IndexError):
            out["power_limit_w"] = None
    return out


#: A record's device fields where its work ran on the host alone (no
#: card touched): ``device`` is ``host``, with no card name or power
#: limit beside the numbers.
HOST_FIELDS = {"device": "host"}


def write_record(path: str, record: dict, sort_keys: bool = False) -> None:
    """Write ``record`` as indented JSON to ``path`` (parents made);
    ``sort_keys`` for the tools whose JAX twin writes its keys sorted."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str, sort_keys=sort_keys)
        f.write("\n")
    print(json.dumps({"wrote": path}), flush=True)


def append_line(path, rec):
    """Append ``rec`` as one JSON line, durably; after a torn last line
    (a killed writer's) it starts a new line, so the torn one alone is
    lost."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a+b") as f:
        f.seek(0, os.SEEK_END)
        if f.tell():
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                f.write(b"\n")
        f.write((json.dumps(rec) + "\n").encode())
        f.flush()
        os.fsync(f.fileno())


def pct(sorted_vals, q: float):
    """The ``q`` quantile of already sorted values by the JAX tools'
    rule (index ``int(q * n)``, clipped), None when there are none."""
    if not len(sorted_vals):
        return None
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def synchronize(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def summarize_trace(chrome_doc: dict, top: int = 6) -> dict:
    """Digest of an in-memory span-tree document (``to_chrome()``) for a
    bench record, as the JAX tools embed it (``tools/trace_analyze.py``
    ``summarize``): the names ranked by total self time (a span's
    duration minus its direct children's, clipped at zero) and the
    slowest trace's critical path (root to leaf, descending into the
    longest child at every level)."""
    spans = []
    for e in chrome_doc.get("traceEvents", []):
        args = e.get("args") or {}
        if e.get("ph") != "X" or "span_id" not in args:
            continue
        spans.append({"name": e.get("name", "?"),
                      "ts_us": float(e.get("ts", 0.0)),
                      "dur_us": float(e.get("dur", 0.0)),
                      "trace_id": args.get("trace_id"),
                      "span_id": args["span_id"],
                      "parent_id": args.get("parent_id")})
    if not spans:
        return {"n_spans": 0, "n_traces": 0, "top_self": [],
                "critical_path": []}
    traces: dict = {}
    for s in spans:
        t = traces.setdefault(s["trace_id"], {
            "spans": {}, "children": defaultdict(list), "roots": []})
        t["spans"][s["span_id"]] = s
    for s in spans:
        t = traces[s["trace_id"]]
        if s["parent_id"] is not None and s["parent_id"] in t["spans"]:
            t["children"][s["parent_id"]].append(s)
        else:
            t["roots"].append(s)
    self_by_name: dict = defaultdict(float)
    calls: dict = defaultdict(int)
    slowest = None
    for t in traces.values():
        for kids in t["children"].values():
            kids.sort(key=lambda s: s["ts_us"])
        selfs = {}
        for sid, s in t["spans"].items():
            child_us = sum(k["dur_us"] for k in t["children"].get(sid, ()))
            selfs[sid] = max(s["dur_us"] - child_us, 0.0)
            self_by_name[s["name"]] += selfs[sid]
            calls[s["name"]] += 1
        for root in sorted(t["roots"], key=lambda s: s["ts_us"]):
            if slowest is None or root["dur_us"] > slowest[0]["dur_us"]:
                slowest = (root, t, selfs)
    path = []
    if slowest is not None:
        node, t, selfs = slowest
        while True:
            path.append({"name": node["name"],
                         "dur_us": round(node["dur_us"], 1),
                         "self_us": round(selfs[node["span_id"]], 1)})
            kids = t["children"].get(node["span_id"])
            if not kids:
                break
            node = max(kids, key=lambda s: s["dur_us"])
    ranked = sorted(self_by_name, key=lambda n: -self_by_name[n])[:top]
    return {
        "n_spans": len(spans),
        "n_traces": len(traces),
        "top_self": [{"name": n, "self_us": round(self_by_name[n], 1),
                      "calls": calls[n]} for n in ranked],
        "critical_path": path,
    }
