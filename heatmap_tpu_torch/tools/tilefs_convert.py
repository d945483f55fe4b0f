"""Convert a store artifact to the zero-copy tilefs format.

The port's twin of ``tools/tilefs_convert.py`` (host work only; the
``tilefs-z*.bin`` bytes equal the JAX tool's from the same store):

- ``arrays:DIR`` (or a bare npz dir, multihost ``host*/`` shards
  included): writes ``tilefs-z*.bin`` mirrors beside the levels, in
  place by default or into ``--out``; the npz levels stay as the
  per-zoom fallback for a torn mirror;
- ``delta:ROOT``: writes the mirrors into the CURRENT base, so the store
  serves zero-copy at once; the next compaction rebuilds them;
- ``jsonl:PATH`` / ``dir:PATH`` blob stores need ``--out``: the blobs
  are materialised into columnar levels (npz and tilefs) there.

``--verify`` deep-checks every written file (header, footer, trailer,
payload crcs). Writes are atomic (tmp + rename). The summary (the JAX
tool's keys, then ``device``: ``host``, the work touches no card) is
printed and written to ``--record`` (``--out`` is the JAX tool's
target directory).

    python -m heatmap_tpu_torch.tools.tilefs_convert STORE_SPEC [--out DIR]
        [--no-levels] [--verify]
        [--record build/torch_bench/tilefs_convert.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from heatmap_tpu_torch.tools._common import (HOST_FIELDS, default_out,
                                             write_record)

#: The JAX tool's summary keys (``verified`` and ``corrupt`` with
#: ``--verify``).
SUMMARY_KEYS = ("spec", "kind", "dest", "files", "bytes")


def _store_to_loaded(store) -> dict:
    """Blob-store layers -> loaded-column levels ({zoom: cols})."""
    from heatmap_tpu_torch.tilemath.morton import morton_decode_np

    staged: dict[int, dict[str, list]] = {}
    seen = set()
    for layer in store.layers.values():
        if (layer.user, layer.timespan) in seen:
            continue  # the "default" alias shares the all|alltime layer
        seen.add((layer.user, layer.timespan))
        for zoom, lvl in layer.levels.items():
            rows, cols = morton_decode_np(lvl.codes)
            cz = zoom - (layer.result_delta or 0)
            dst = staged.setdefault(int(zoom), {
                "row": [], "col": [], "value": [], "user": [],
                "timespan": [], "coarse_row": [], "coarse_col": [],
                "zoom": int(zoom), "coarse_zoom": int(cz)})
            dst["row"].append(rows)
            dst["col"].append(cols)
            dst["value"].append(np.asarray(lvl.values, np.float64))
            n = len(lvl.codes)
            dst["user"].append(np.full(n, layer.user, dtype=object))
            dst["timespan"].append(np.full(n, layer.timespan, dtype=object))
            dst["coarse_row"].append(rows >> (layer.result_delta or 0))
            dst["coarse_col"].append(cols >> (layer.result_delta or 0))
    out = {}
    for zoom, cols in staged.items():
        merged = {"zoom": np.asarray(cols["zoom"]),
                  "coarse_zoom": np.asarray(cols["coarse_zoom"])}
        for k in ("row", "col", "value", "coarse_row", "coarse_col"):
            merged[k] = np.concatenate(cols[k]) if cols[k] else np.array([])
        for k in ("user", "timespan"):
            merged[k] = np.concatenate(cols[k]).astype(str)
        out[zoom] = merged
    return out


def _loaded_to_finalized(levels: dict) -> list:
    """Loaded columns -> finalized dicts (``write_levels`` input)."""
    out = []
    for zoom in sorted(levels):
        cols = dict(levels[zoom])
        for name in ("user", "timespan"):
            vals = np.asarray(cols.pop(name), str)
            names, idx = np.unique(vals, return_inverse=True)
            cols[f"{name}_idx"] = idx.astype(np.int32)
            cols[f"{name}_names"] = names
        cols["zoom"] = int(np.asarray(cols["zoom"]))
        cols["coarse_zoom"] = int(np.asarray(cols["coarse_zoom"]))
        for k in ("row", "col", "coarse_row", "coarse_col"):
            cols[k] = np.asarray(cols[k], np.int64)
        cols["value"] = np.asarray(cols["value"], np.float64)
        out.append(cols)
    return out


def convert(spec: str, out: str | None = None, *,
            write_levels: bool = True) -> dict:
    """Convert ``spec``; returns the summary the command prints."""
    from heatmap_tpu_torch.io.sinks import LevelArraysSink
    from heatmap_tpu_torch.serve.store import (TileStore, _load_levels,
                                               _parse_store_spec)
    from heatmap_tpu_torch.tilefs import format as tilefs_format

    kind, path = _parse_store_spec(spec)
    if kind in ("arrays", "tilefs"):
        levels = _load_levels(path)
        dest = out or path
        if out and os.path.abspath(out) != os.path.abspath(path):
            os.makedirs(out, exist_ok=True)
            if write_levels:
                LevelArraysSink(out).write_levels(
                    _loaded_to_finalized(levels))
        written = tilefs_format.write_tilefs_from_loaded(dest, levels)
    elif kind == "delta":
        from heatmap_tpu_torch.delta.compact import read_current

        if out:
            raise SystemExit("--out is not supported for delta stores: "
                             "mirrors go into the CURRENT base")
        cur = read_current(path)
        if not cur.get("base"):
            raise SystemExit(f"{spec}: empty delta store (no base); "
                             "apply a batch or compact first")
        dest = os.path.join(path, cur["base"])
        written = tilefs_format.write_tilefs_from_loaded(
            dest, LevelArraysSink.load(dest))
    else:  # jsonl / dir blob stores
        if not out:
            raise SystemExit(f"{spec}: blob stores need --out DIR (the "
                             "columnar materialization target)")
        dest = out
        levels = _store_to_loaded(TileStore(spec))
        os.makedirs(out, exist_ok=True)
        if write_levels:
            LevelArraysSink(out).write_levels(_loaded_to_finalized(levels))
        written = tilefs_format.write_tilefs_from_loaded(out, levels)
    return {"spec": spec, "kind": kind, "dest": dest,
            "files": [os.path.basename(p) for p in written],
            "bytes": int(sum(os.path.getsize(p) for p in written))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="heatmap_tpu_torch.tools.tilefs_convert",
        description="convert a store artifact to the zero-copy tilefs "
                    "format (heatmap_tpu_torch.tilefs)")
    ap.add_argument("spec", help="store spec: arrays:DIR, delta:ROOT, "
                                 "jsonl:PATH, dir:PATH, or a bare path")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write the converted store here instead of in "
                         "place (required for blob stores)")
    ap.add_argument("--no-levels", action="store_true",
                    help="skip the npz level mirror when materializing "
                         "to --out (tilefs only: no torn-file fallback)")
    ap.add_argument("--verify", action="store_true",
                    help="deep-verify every written file (payload crcs)")
    ap.add_argument("--record", default=default_out("tilefs_convert"),
                    help="summary file (default %(default)s)")
    args = ap.parse_args(argv)

    from heatmap_tpu_torch.tilefs import format as tilefs_format

    summary = convert(args.spec, args.out, write_levels=not args.no_levels)
    if args.verify:
        bad = {}
        for name in summary["files"]:
            reason = tilefs_format.verify_tilefs(
                os.path.join(summary["dest"], name))
            if reason is not None:
                bad[name] = reason
        summary["verified"] = not bad
        if bad:
            summary["corrupt"] = bad
    summary.update(HOST_FIELDS)
    print(json.dumps(summary, indent=2))
    write_record(args.record, summary)
    return 1 if summary.get("corrupt") else 0


if __name__ == "__main__":
    sys.exit(main())
