"""``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix; each lives in a file of
its own (``configs/<config>.json``, ``traffic/<traffic>.json``), the
traffic file names its driver (``drivers/<driver>.py``), and every
metric is read by ``metrics/<metric>.py``. Adding a cell, a
configuration or a metric adds files and entries; it edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_spec(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files read."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def metrics_of(spec: dict, name: str):
    """The cell's end-to-end metrics, and its per-layer metrics: those
    that list the cell, or that list no cells and move a metric the cell
    reports."""
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in names
                                  else [])]
    return e2e, per_layer


def cell(name: str, spec: dict | None = None,
         root: pathlib.Path = ROOT) -> Cell:
    spec = spec if spec is not None else load_spec(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{', '.join(w['name'] for w in spec['workloads'])})")
    cfg = next(c for c in spec["configs"] if c["name"] == entry["config"])
    e2e, per_layer = metrics_of(spec, name)
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config_name=entry["config"],
        traffic_name=entry["traffic"],
        config=_json(root / cfg["file"]),
        traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def driver_class(cell: Cell):
    """The ``Driver`` class of the module the traffic file names."""
    module = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    return module.Driver


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``, or, where there is no such
    file, of ``metrics/<stem>.py`` for a name ``<stem>.<cell kind>``: one
    reader serves a quantity split by the cells that report it."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    mod_name = "benchmark.metrics._" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
