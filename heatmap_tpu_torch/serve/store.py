"""TileStore: batch egress -> read-optimized per-zoom tile index.

The port's copy of heatmap_tpu/serve/store.py: for the same artifact it
builds the same index (same Morton levels, same float summation order),
so every served byte matches the JAX package's, temporal fold views
(``temporal_view``) included.

Loads any batch egress artifact the job side writes —

- ``arrays:DIR``   columnar per-level npz (LevelArraysSink), including
                   a directory of multihost ``host*/`` shards, merged
                   through the existing io/merge.py level mergers;
- ``jsonl:PATH``   blob records (JSONLBlobSink lines);
- ``dir:PATH``     one blob JSON file per id (DirectoryBlobSink);
- ``delta:ROOT``   an incremental delta store (heatmap_tpu_torch.delta):
                   the current base pyramid overlaid with the live
                   delta stack, additively merged on read;
- ``tilefs:ROOT``  a zero-copy mmap'd tilefs store (heatmap_tpu_torch.tilefs):
                   ``tilefs-z*.bin`` column segments served straight
                   from the kernel page cache (N backends on one host
                   share the pyramid's pages instead of N heap copies);
                   handles both plain converted dirs and delta-shaped
                   roots (mmap'd base ⊕ in-heap live deltas), falling
                   back to the sibling npz level per zoom when a tilefs
                   file is torn — served bytes are identical either way;
- ``writeplane:ROOT`` a write-plane root (heatmap_tpu_torch.writeplane):
                   the per-range stores one manifest epoch names, merged;

— into per-layer, per-detail-zoom **Morton-keyed sorted arrays**
(tilemath/morton.py): a tile request at coarse tile (z, row, col) is a
single ``searchsorted`` range probe, because every detail tile under a
coarse tile is a contiguous Morton range ``[code << 2d, (code+1) << 2d)``.

Layers map the reference's blob-id prefix (``user|timespan``) to URL
path segments. By default every (user, timespan) pair present in the
artifact becomes a layer named ``user|timespan``, and ``default``
aliases ``all|alltime`` when present — so a fresh count job serves at
``/tiles/default/...`` with zero configuration.

``reload()`` re-reads the artifact and atomically swaps the index,
bumping ``generation`` — the cache invalidation token — so a newer job
run is picked up without restarting the server. ``refresh_layers()``
is the targeted sibling for delta stores: it swaps the index WITHOUT
the bump, so only the tile keys a delta actually touched need explicit
invalidation (heatmap_tpu_torch.delta.refresh_serving) and the rest of the
cache survives.

Numpy-only on purpose: no device work (the io/merge.py offline
discipline) — a tile server must keep serving beside a busy or dead
card.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from heatmap_tpu_torch import obs
from heatmap_tpu_torch.analytics import integral as integral_build
from heatmap_tpu_torch.io.sinks import LevelArraysSink
from heatmap_tpu_torch.synopsis import build as synopsis_build
from heatmap_tpu_torch.synopsis import metrics as synopsis_metrics
from heatmap_tpu_torch.tilemath.keys import parse_tile_id
from heatmap_tpu_torch.tilemath.morton import morton_encode_np

#: Store spec kinds ``TileStore`` accepts (subset of the sink kinds —
#: the batch egress surfaces that persist to disk — plus the delta
#: store overlay).
STORE_KINDS = ("arrays", "jsonl", "dir", "delta", "tilefs", "writeplane")


class Level:
    """One detail-zoom slice of a layer: sorted Morton codes + values."""

    __slots__ = ("zoom", "codes", "values", "vmax")

    def __init__(self, zoom: int, codes: np.ndarray, values: np.ndarray):
        order = np.argsort(codes, kind="stable")
        self.zoom = int(zoom)
        self.codes = np.asarray(codes, np.int64)[order]
        self.values = np.asarray(values, np.float64)[order]
        self.vmax = float(self.values.max()) if len(self.values) else 0.0

    def range(self, lo: int, hi: int):
        """(codes, values) with codes in ``[lo, hi)`` — one searchsorted
        pair; Morton contiguity makes this the whole spatial query."""
        i = np.searchsorted(self.codes, lo, side="left")
        j = np.searchsorted(self.codes, hi, side="left")
        return self.codes[i:j], self.values[i:j]

    def lookup(self, code: int) -> float:
        """Single-cell probe (ancestor fills); 0.0 on miss."""
        i = int(np.searchsorted(self.codes, code, side="left"))
        if i < len(self.codes) and int(self.codes[i]) == code:
            return float(self.values[i])
        return 0.0

    def __len__(self):
        return len(self.codes)


class MappedLevel(Level):
    """Zero-copy Level over tilefs mmap column views.

    The writer already applied Level's stable argsort-by-code, so the
    views are used verbatim, and vmax comes from the footer index —
    construction touches no data pages; the kernel faults them in only
    when a tile's Morton range is actually probed."""

    __slots__ = ()

    def __init__(self, zoom: int, codes, values, vmax: float):
        self.zoom = int(zoom)
        self.codes = codes
        self.values = values
        self.vmax = float(vmax)


class SynopsisView:
    """One decoded wavelet synopsis level, ready to serve.

    ``level`` is the decoded count grid as an ordinary :class:`Level`
    (render.py treats it like any stored level); ``max_err`` the
    stamped L-inf bound from the artifact header; ``stale`` marks a
    provisional early-serve overlay (ingest published the micro-batch
    counts before the exact apply landed).
    """

    __slots__ = ("level", "max_err", "stale")

    def __init__(self, level: Level, max_err: float, stale: bool = False):
        self.level = level
        self.max_err = float(max_err)
        self.stale = bool(stale)


class Layer:
    """One (user, timespan) slice: detail levels + raw blob documents.

    ``blob_json`` holds the verbatim on-disk JSON document per coarse
    tile for blob-record stores (jsonl:/dir:), so the JSON endpoint
    serves byte-identical bytes to the artifact. Columnar stores carry
    no document form; render.py rebuilds it in stored-row order.

    ``synopses`` maps detail zooms to decoded :class:`SynopsisView`\\ s
    when the artifact carries ``synopsis-z*.npz`` files; empty
    otherwise. Exact serving never reads it.

    ``integrals`` maps detail zooms to
    :class:`heatmap_tpu_torch.analytics.IntegralPair` summed-area tables when
    the artifact carries ``integral-z*.npz`` files (with live delta
    rows already folded in — exact); empty otherwise, in which case
    /query falls through to the exact level rows.
    """

    __slots__ = ("user", "timespan", "levels", "result_delta", "blob_json",
                 "synopses", "integrals")

    def __init__(self, user: str, timespan: str, result_delta: int | None):
        self.user = user
        self.timespan = timespan
        self.levels: dict[int, Level] = {}
        self.result_delta = result_delta
        self.blob_json: dict[tuple, str] = {}
        self.synopses: dict[int, SynopsisView] = {}
        self.integrals: dict[int, "integral_build.IntegralPair"] = {}

    @property
    def detail_zooms(self) -> list[int]:
        return sorted(self.levels)

    def source_zoom(self, detail_zoom: int) -> int | None:
        """Nearest stored detail zoom for a wanted one: exact when
        stored; else the closest FINER level (rollup is exact), else
        the closest coarser (quadrant upsample)."""
        if detail_zoom in self.levels:
            return detail_zoom
        finer = [z for z in self.levels if z > detail_zoom]
        if finer:
            return min(finer)
        coarser = [z for z in self.levels if z < detail_zoom]
        return max(coarser) if coarser else None


def _parse_store_spec(spec: str) -> tuple[str, str]:
    kind, sep, rest = spec.partition(":")
    if sep and kind in STORE_KINDS:
        return kind, rest
    # Bare paths: sniff like open_source/open_sink do.
    if spec.endswith((".jsonl", ".ndjson")):
        return "jsonl", spec
    if os.path.isdir(spec):
        from heatmap_tpu_torch.tilefs.format import sniff_tilefs

        names = os.listdir(spec)
        if "MANIFEST" in names or (
                "ranges" in names and any(
                    n.startswith("manifest-") for n in names)):
            # A write-plane root (epoch-unified manifest over per-range
            # delta stores — heatmap_tpu_torch/writeplane/).
            return "writeplane", spec
        if "CURRENT" in names or "journal" in names:
            # A converted delta store (tilefs files in the CURRENT
            # base) serves zero-copy by default — byte-identity makes
            # the mmap path a pure speedup, never a behavior change.
            from heatmap_tpu_torch.delta.compact import read_current

            cur = read_current(spec)
            if cur.get("base") and sniff_tilefs(
                    os.path.join(spec, cur["base"])):
                return "tilefs", spec
            return "delta", spec
        if sniff_tilefs(spec):
            return "tilefs", spec
        if any(n.startswith("level_z") for n in names) or any(
                n.startswith("host") and
                os.path.isdir(os.path.join(spec, n)) for n in names):
            return "arrays", spec
        return "dir", spec
    raise ValueError(
        f"unrecognized store spec {spec!r}: kind must be one of "
        f"{', '.join(STORE_KINDS)} (e.g. arrays:levels/)"
    )


def _live_delta_epoch(root: str, cur: dict) -> int:
    """Newest epoch visible in a delta-shaped store: max of CURRENT's
    ``applied_through`` and the live journal head. The disk cache tier
    keys rendered bytes on this, so every apply invalidates exactly the
    epoch's worth of entries while compaction (which folds the head
    into ``applied_through`` without changing it) invalidates none."""
    from heatmap_tpu_torch.delta.compact import live_entries

    epochs = [int(e["epoch"]) for e in live_entries(root)]
    return max([int(cur.get("applied_through", 0) or 0)] + epochs)


def _combine_cells(codes: np.ndarray, values: np.ndarray):
    """Sum duplicate Morton cells and drop non-positive results —
    Level wants unique sorted codes (``lookup`` probes a single row)."""
    order = np.argsort(codes, kind="stable")
    codes, values = codes[order], values[order]
    uniq, starts = np.unique(codes, return_index=True)
    sums = np.add.reduceat(values, starts) if len(values) else values
    keep = sums > 0.0
    return uniq[keep], sums[keep]


def _finalized_to_loaded(merged) -> dict[int, dict]:
    """Finalized (dictionary-encoded) -> loaded (string columns), the
    shape LevelArraysSink.load returns."""
    out = {}
    for lvl in merged:
        cols = dict(lvl)
        cols["user"] = np.asarray(lvl["user_names"])[lvl["user_idx"]]
        cols["timespan"] = np.asarray(
            lvl["timespan_names"])[lvl["timespan_idx"]]
        out[int(lvl["zoom"])] = cols
    return out


def _load_levels(path: str) -> dict[int, dict]:
    """``arrays:`` loader: plain LevelArraysSink dir, or a directory of
    multihost ``host*/`` shards merged through io/merge.py."""
    names = sorted(os.listdir(path))
    shard_dirs = [os.path.join(path, n) for n in names
                  if n.startswith("host")
                  and os.path.isdir(os.path.join(path, n))]
    if shard_dirs and not any(n.startswith("level_z") for n in names):
        from heatmap_tpu_torch.io.merge import merge_level_dirs

        return _finalized_to_loaded(merge_level_dirs(shard_dirs))
    return LevelArraysSink.load(path)


def _iter_blob_records(kind: str, path: str):
    """Yield (blob_id, raw_json_str) with last-write-wins per id —
    JSONLBlobSink.load upsert semantics, raw strings preserved."""
    if kind == "jsonl":
        out: dict[str, str] = {}
        with open(path) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    out[rec["id"]] = rec["heatmap"]
        yield from out.items()
        return
    for name in sorted(os.listdir(path)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(path, name)) as f:
            yield name[: -len(".json")], f.read()


class TileStore:
    """The serving index over one batch-egress artifact.

    ``layers`` (optional) maps exposed layer names to ``"user|timespan"``
    selectors; by default every pair found in the artifact is exposed
    under its own ``user|timespan`` name plus the ``default`` alias for
    ``all|alltime``. Unknown selectors raise at load time — a typo'd
    ``--layers`` must not 404 forever at runtime.
    """

    def __init__(self, spec: str, layers: dict[str, str] | None = None):
        self.spec = spec
        self.kind, self.path = _parse_store_spec(spec)
        self._layer_spec = dict(layers) if layers else None
        self._lock = threading.Lock()
        self.generation = 0
        # Synopsis cache token: bumped by every index swap AND every
        # provisional publish, and folded into synopsis cache keys —
        # approximate bytes must never outlive the view they were
        # decoded from (exact tiles keep the cheaper generation +
        # targeted-invalidation scheme).
        self.synopsis_epoch = 0
        # Delta-apply token for the disk cache tier: the newest epoch
        # visible in the store (max of CURRENT's applied_through and
        # the live journal head) for delta-shaped roots, 0 otherwise.
        # Invariant across compaction — the fold sets applied_through
        # to the epoch of the newest delta it consumed — so disk-cached
        # renders survive compaction but can never outlive an apply.
        self.delta_epoch = 0
        self._layers: dict[str, Layer] = {}
        # Temporal fold views (heatmap_tpu_torch.temporal), keyed by fold
        # token: tiny LRU — each view is a full layer index over the
        # cut, and distinct live cuts are few (the active windows plus
        # whatever as_of epochs clients are replaying).
        self._temporal_views: dict = {}
        self.reload(_initial=True)

    # -- queries -----------------------------------------------------------

    @property
    def layers(self) -> dict[str, Layer]:
        return self._layers

    def layer(self, name: str) -> Layer | None:
        return self._layers.get(name)

    def layer_names(self) -> list[str]:
        return sorted(self._layers)

    # -- (re)loading -------------------------------------------------------

    def reload(self, _initial: bool = False) -> int:
        """Re-read the artifact and atomically swap the index; returns
        the new generation (the cache-invalidation token).

        Build-before-swap is a contract the serve tier's degraded mode
        relies on (serve/http.py, tests/test_chaos.py): ``_build()``
        runs to completion BEFORE ``self._layers`` is touched, so a
        reload that raises — unreadable artifact, store mid-rewrite —
        leaves the last-good index serving and the generation
        unchanged."""
        t0 = time.monotonic()
        built = self._build()
        with self._lock:
            old = self.generation
            self._layers = built
            if not _initial:
                self.generation += 1
            self.synopsis_epoch += 1
            generation = self.generation
        # Full reloads invalidate every cached tile via the generation
        # bump; the event makes them distinguishable from targeted
        # delta refreshes in the log.
        obs.emit("store_reload", old_generation=old, generation=generation,
                 levels=sum(len(layer.levels) for layer in built.values()),
                 seconds=round(time.monotonic() - t0, 6), spec=self.spec,
                 layers=len(built), initial=bool(_initial))
        return generation

    def refresh_layers(self) -> int:
        """Re-read the artifact and swap the index WITHOUT bumping the
        generation — the delta-apply path: an additive delta cannot
        change untouched tiles' bytes, so their cache entries stay
        valid and the caller invalidates only the affected keys
        (heatmap_tpu_torch.delta.refresh_serving). Returns the (unchanged)
        generation."""
        built = self._build()
        with self._lock:
            self._layers = built
            # Fresh synopsis views supersede any provisional overlay
            # published since the last swap (the early-serve contract).
            self.synopsis_epoch += 1
            return self.generation

    #: Max distinct fold views kept per store (LRU).
    TEMPORAL_VIEW_CAP = 8

    def temporal_root(self) -> str | None:
        """The delta-store root behind this store, if its spec has one
        (delta: always; tilefs: when the path is a delta-shaped root).
        Temporal folds need CURRENT + journal + buckets — a plain
        artifact has no history to cut."""
        if self.kind == "delta":
            return self.path
        if self.kind == "tilefs" and os.path.exists(
                os.path.join(self.path, "CURRENT")):
            return self.path
        return None

    def temporal_view(self, *, as_of: float | None = None,
                      window: float | None = None,
                      decay: float | None = None):
        """Layers for a temporal cut: fold the selected buckets + live
        deltas (heatmap_tpu_torch.temporal.fold) and index them exactly like
        the all-time build — same Morton levels, same naming — so the
        render path is unchanged downstream of layer lookup.

        Returns ``(layers, token)``; the token names the fold inputs
        and is the cache-key component for as_of/decay tiles. Views are
        memoised per (token, generation): history below a cut is
        immutable under ingest, so a view keeps serving until the cut
        itself changes (retraction/compaction below it, or a reload).
        Raises ``ValueError`` for a store with no temporal config and
        ``TornBucketError`` when a selected bucket is quarantined —
        the serve tier's stale-if-error path takes it from there."""
        root = self.temporal_root()
        if root is None:
            raise ValueError(
                f"store {self.spec} has no delta root — temporal "
                "queries need a delta-shaped store")
        from heatmap_tpu_torch.temporal import fold as tfold
        from heatmap_tpu_torch.temporal.metrics import TEMPORAL_FOLD_SECONDS

        sel = tfold.select_fold(root, as_of=as_of, window=window,
                                decay=decay)
        key = (sel.token, self.generation)
        with self._lock:
            view = self._temporal_views.get(key)
            if view is not None:
                return view
        t0 = time.monotonic()
        levels = tfold.fold_levels(root, sel, decay_half_life=decay)
        by_pair = self._build_from_levels(_finalized_to_loaded(levels))
        named = self._name_layers(by_pair, strict=False)
        TEMPORAL_FOLD_SECONDS.observe(time.monotonic() - t0)
        view = (named, sel.token)
        with self._lock:
            self._temporal_views[key] = view
            while len(self._temporal_views) > self.TEMPORAL_VIEW_CAP:
                self._temporal_views.pop(
                    next(iter(self._temporal_views)))
        return view

    def _build(self) -> dict[str, Layer]:
        syn_dir: str | None = None
        delta_dirs: list[str] = []
        delta_epoch = 0
        if self.kind == "arrays":
            by_pair = self._build_from_levels(_load_levels(self.path))
            syn_dir = self.path
        elif self.kind == "delta":
            from heatmap_tpu_torch.delta.compact import (load_overlay_levels,
                                                   overlay_dirs,
                                                   read_current)
            from heatmap_tpu_torch.tilefs import sniff_tilefs

            cur = read_current(self.path)
            delta_epoch = _live_delta_epoch(self.path, cur)
            if cur.get("base"):
                syn_dir = os.path.join(self.path, cur["base"])
                delta_dirs = [
                    d for d in overlay_dirs(self.path)
                    if os.path.normpath(d) != os.path.normpath(syn_dir)]
            if syn_dir is not None and sniff_tilefs(syn_dir):
                # A converted base serves zero-copy even under the
                # explicit delta: spec — same bytes, mmap'd pages.
                by_pair = self._build_from_tilefs(syn_dir, delta_dirs)
            else:
                by_pair = self._build_from_levels(
                    _finalized_to_loaded(load_overlay_levels(self.path)))
        elif self.kind == "writeplane":
            from heatmap_tpu_torch.delta.compact import drop_zero_rows
            from heatmap_tpu_torch.io.merge import merge_level_dirs
            from heatmap_tpu_torch.writeplane import manifest as wp_manifest

            # One manifest read pins the whole cross-range overlay:
            # the snapshot names immutable artifact dirs, so the merge
            # below can never mix two epochs' views even while writers
            # advance. The manifest epoch is the disk-cache token (the
            # writeplane analog of _live_delta_epoch — it bumps on
            # every publish, i.e. exactly when visible bytes can
            # change). A torn newest manifest falls back to the last
            # good epoch inside read_manifest.
            snap = wp_manifest.read_manifest(self.path)
            dirs = ([] if snap is None
                    else wp_manifest.overlay_dirs(self.path, snap))
            delta_epoch = 0 if snap is None else int(snap["epoch"])
            merged = (drop_zero_rows(merge_level_dirs(dirs))
                      if dirs else [])
            by_pair = self._build_from_levels(_finalized_to_loaded(merged))
        elif self.kind == "tilefs":
            names = (os.listdir(self.path)
                     if os.path.isdir(self.path) else [])
            if "CURRENT" in names or "journal" in names:
                from heatmap_tpu_torch.delta.compact import (overlay_dirs,
                                                       read_current)

                cur = read_current(self.path)
                delta_epoch = _live_delta_epoch(self.path, cur)
                base = (os.path.join(self.path, cur["base"])
                        if cur.get("base") else None)
                delta_dirs = [
                    d for d in overlay_dirs(self.path)
                    if base is None
                    or os.path.normpath(d) != os.path.normpath(base)]
                by_pair = self._build_from_tilefs(base, delta_dirs)
                syn_dir = base
            else:
                by_pair = self._build_from_tilefs(self.path, [])
                syn_dir = self.path
        else:
            by_pair = self._build_from_blobs(
                _iter_blob_records(self.kind, self.path))
        if syn_dir is not None:
            self._attach_synopses(by_pair, syn_dir, delta_dirs)
            self._attach_integrals(by_pair, syn_dir, delta_dirs)
        named = self._name_layers(by_pair, strict=True)
        self.delta_epoch = delta_epoch
        return named

    def _name_layers(self, by_pair: dict, *, strict: bool) -> dict:
        """Apply the exposed-layer naming to a (user, timespan) -> Layer
        map: the ``--layers`` spec when given, else every pair under its
        own name plus the ``default`` alias. ``strict`` raises on a
        spec'd pair the artifact lacks (a typo'd --layers must not 404
        forever); temporal folds pass strict=False — a window with no
        data for some pair is an honest 404, not a config error."""
        named: dict[str, Layer] = {}
        if self._layer_spec is None:
            for (user, ts), layer in by_pair.items():
                named[f"{user}|{ts}"] = layer
            if ("all", "alltime") in by_pair:
                named.setdefault("default", by_pair[("all", "alltime")])
        else:
            for name, sel in self._layer_spec.items():
                user, _, ts = sel.partition("|")
                layer = by_pair.get((user, ts or "alltime"))
                if layer is None:
                    if strict:
                        raise ValueError(
                            f"layer {name!r}: no ({user!r}, "
                            f"{ts or 'alltime'!r}) slice in {self.spec}; "
                            "available: "
                            f"{sorted('|'.join(p) for p in by_pair)}"
                        )
                    continue
                named[name] = layer
        return named

    def _build_from_tilefs(self, base_dir: str | None,
                           delta_dirs: list[str]) -> dict:
        """mmap'd base ⊕ in-heap live deltas, byte-identical to the
        heap merge.

        Pairs untouched by any delta serve :class:`MappedLevel` views
        straight off the page cache (zero copies, zero data pages
        faulted at build time). Pairs a delta touched are composed in
        the exact order the heap path sums them — base rows first, then
        deltas oldest-first, stable-sorted by code, ``np.add.reduceat``
        per cell, exact zeros dropped — so float summation order (and
        therefore every served byte) matches ``load_overlay_levels``.
        A torn/unreadable tilefs file falls back to the sibling npz
        levels for that zoom; the recovery sweep owns quarantining it.
        """
        from heatmap_tpu_torch.tilefs import format as tilefs_format

        # Live delta rows per (zoom, pair), in overlay (oldest-first)
        # order — the summation order the heap merge uses.
        delta_rows: dict[int, dict[tuple, list]] = {}
        delta_rd: dict[int, int] = {}
        for d in delta_dirs:
            try:
                loaded = LevelArraysSink.load(d)
            except OSError:
                continue
            for zoom, cols in loaded.items():
                zoom = int(zoom)
                users = np.asarray(cols["user"], str)
                tss = np.asarray(cols["timespan"], str)
                codes = morton_encode_np(
                    np.asarray(cols["row"], np.int64),
                    np.asarray(cols["col"], np.int64))
                values = np.asarray(cols["value"], np.float64)
                delta_rd[zoom] = int(cols["zoom"]) - int(
                    cols["coarse_zoom"])
                pair_key = np.char.add(np.char.add(users, "|"), tss)
                for pk in np.unique(pair_key):
                    sel = pair_key == pk
                    user, _, ts = str(pk).partition("|")
                    delta_rows.setdefault(zoom, {}).setdefault(
                        (user, ts), []).append((codes[sel], values[sel]))

        tilefs_files = (tilefs_format.list_tilefs(base_dir)
                        if base_dir else {})
        npz_zooms = set()
        if base_dir and os.path.isdir(base_dir):
            for name in os.listdir(base_dir):
                if name.startswith("level_z") or (
                        name.startswith("host")
                        and os.path.isdir(os.path.join(base_dir, name))):
                    npz_zooms.add(name)
        heap_cols: dict[int, dict] | None = None

        def heap_zoom(zoom: int):
            # Lazy: the npz dir is only loaded when a zoom has no
            # servable tilefs file (partial conversion or a torn one).
            nonlocal heap_cols
            if heap_cols is None:
                heap_cols = (_load_levels(base_dir)
                             if base_dir and npz_zooms else {})
            return heap_cols.get(zoom)

        by_pair: dict[tuple, Layer] = {}

        def compose(zoom: int, parts: list) -> Level:
            codes = np.concatenate([p[0] for p in parts])
            values = np.concatenate([p[1] for p in parts])
            order = np.argsort(codes, kind="stable")
            codes, values = codes[order], values[order]
            uniq, starts = np.unique(codes, return_index=True)
            sums = (np.add.reduceat(values, starts)
                    if len(values) else values)
            keep = sums != 0.0  # retraction zeros, like drop_zero_rows
            return Level(zoom, uniq[keep], sums[keep])

        all_zooms = sorted(set(tilefs_files) | set(delta_rows))
        if npz_zooms:
            # Partially converted dirs: heap levels may carry zooms the
            # tilefs mirrors don't (and vice versa).
            if heap_cols is None:
                heap_cols = _load_levels(base_dir)
            all_zooms = sorted(set(all_zooms) | set(heap_cols))
        for zoom in all_zooms:
            reader = None
            if zoom in tilefs_files:
                from heatmap_tpu_torch import faults

                try:
                    reader = tilefs_format.open_tilefs(tilefs_files[zoom])
                except (tilefs_format.TilefsError, faults.InjectedFault):
                    # Torn file, or an injected tilefs.read fault
                    # (retries=0 by policy): either way the sibling
                    # npz level serves this zoom, bytes unchanged.
                    reader = None
            zoom_deltas = dict(delta_rows.get(zoom, {}))
            if reader is not None:
                rd = reader.zoom - reader.coarse_zoom
                for seg in reader.pairs:
                    pair = (seg["user"], seg["timespan"])
                    codes, values = reader.arrays(seg)
                    layer = by_pair.setdefault(
                        pair, Layer(pair[0], pair[1], rd))
                    extra = zoom_deltas.pop(pair, None)
                    if extra:
                        layer.levels[zoom] = compose(
                            zoom, [(codes, values)] + extra)
                    else:
                        layer.levels[zoom] = MappedLevel(
                            zoom, codes, values, float(seg["vmax"]))
            else:
                cols = heap_zoom(zoom)
                rd = (int(cols["zoom"]) - int(cols["coarse_zoom"])
                      if cols is not None else delta_rd.get(zoom))
                if cols is not None:
                    users = np.asarray(cols["user"], str)
                    tss = np.asarray(cols["timespan"], str)
                    codes = morton_encode_np(
                        np.asarray(cols["row"], np.int64),
                        np.asarray(cols["col"], np.int64))
                    values = np.asarray(cols["value"], np.float64)
                    pair_key = np.char.add(np.char.add(users, "|"), tss)
                    for pk in np.unique(pair_key):
                        sel = pair_key == pk
                        user, _, ts = str(pk).partition("|")
                        pair = (user, ts)
                        layer = by_pair.setdefault(
                            pair, Layer(user, ts, rd))
                        extra = zoom_deltas.pop(pair, None)
                        if extra:
                            layer.levels[zoom] = compose(
                                zoom, [(codes[sel], values[sel])] + extra)
                        else:
                            layer.levels[zoom] = Level(
                                zoom, codes[sel], values[sel])
            # Pairs present only in live deltas at this zoom.
            for pair, parts in zoom_deltas.items():
                rd_pair = (reader.zoom - reader.coarse_zoom
                           if reader is not None else delta_rd.get(zoom))
                layer = by_pair.setdefault(
                    pair, Layer(pair[0], pair[1], rd_pair))
                layer.levels[zoom] = compose(zoom, parts)
        return by_pair

    def _build_from_levels(self, levels: dict[int, dict]) -> dict:
        by_pair: dict[tuple, Layer] = {}
        for zoom in sorted(levels):
            cols = levels[zoom]
            users = np.asarray(cols["user"], str)
            tss = np.asarray(cols["timespan"], str)
            delta = int(cols["zoom"]) - int(cols["coarse_zoom"])
            codes = morton_encode_np(
                np.asarray(cols["row"], np.int64),
                np.asarray(cols["col"], np.int64),
            )
            values = np.asarray(cols["value"], np.float64)
            # One pass per (user, timespan) pair present at this level.
            pair_key = np.char.add(np.char.add(users, "|"), tss)
            for pk in np.unique(pair_key):
                sel = pair_key == pk
                user, _, ts = str(pk).partition("|")
                layer = by_pair.setdefault((user, ts),
                                           Layer(user, ts, delta))
                layer.levels[int(zoom)] = Level(zoom, codes[sel],
                                                values[sel])
        return by_pair

    def _build_from_blobs(self, records) -> dict:
        staged: dict[tuple, dict[int, list]] = {}
        by_pair: dict[tuple, Layer] = {}
        for blob_id, raw in records:
            try:
                user, ts, coarse_id = blob_id.split("|", 2)
            except ValueError:
                continue  # not a heatmap blob id; skip like parse_tile_id
            coarse = parse_tile_id(coarse_id)
            if coarse is None:
                continue
            heat = json.loads(raw)
            layer = by_pair.get((user, ts))
            if layer is None:
                layer = by_pair[(user, ts)] = Layer(user, ts, None)
            layer.blob_json[coarse] = raw
            buckets = staged.setdefault((user, ts), {})
            for tid, value in heat.items():
                parsed = parse_tile_id(tid)
                if parsed is None:
                    continue
                z, r, c = parsed
                buckets.setdefault(z, []).append((r, c, float(value)))
                if layer.result_delta is None:
                    layer.result_delta = z - coarse[0]
        for pair, buckets in staged.items():
            layer = by_pair[pair]
            for zoom, rows in buckets.items():
                arr = np.asarray(rows, np.float64)
                layer.levels[zoom] = Level(
                    zoom,
                    morton_encode_np(arr[:, 0].astype(np.int64),
                                     arr[:, 1].astype(np.int64)),
                    arr[:, 2],
                )
        return by_pair

    # -- wavelet synopses --------------------------------------------------

    def _attach_synopses(self, by_pair: dict, syn_dir: str,
                         delta_dirs: list[str]):
        """Decode every readable ``synopsis-z*.npz`` in ``syn_dir``
        into servable :class:`SynopsisView`\\ s on the matching layers.

        For delta stores the synopses describe the BASE pyramid, so
        the live delta dirs' rows are scatter-added on top of the
        decoded grid — an exact addition, keeping every cell within
        the stamped bound of the base ⊕ deltas overlay the exact path
        serves. Unreadable artifacts are skipped (serving falls back
        to exact; the recovery sweep owns quarantining them)."""
        syn = synopsis_build.load_synopses(syn_dir)
        if not syn:
            return
        extras: dict[int, list] = {}
        for d in delta_dirs:
            try:
                loaded = LevelArraysSink.load(d)
            except OSError:
                continue
            for zoom, cols in loaded.items():
                if int(zoom) in syn:
                    extras.setdefault(int(zoom), []).append(cols)
        for zoom, pairs in syn.items():
            for sp in pairs:
                layer = by_pair.get((sp.user, sp.timespan))
                if layer is None:
                    continue
                parts = [[], [], []]
                for cols in extras.get(zoom, ()):
                    users = np.asarray(cols["user"], str)
                    tss = np.asarray(cols["timespan"], str)
                    sel = (users == sp.user) & (tss == sp.timespan)
                    if sel.any():
                        parts[0].append(np.asarray(cols["row"],
                                                   np.int64)[sel])
                        parts[1].append(np.asarray(cols["col"],
                                                   np.int64)[sel])
                        parts[2].append(np.asarray(cols["value"],
                                                   np.float64)[sel])
                extra = (tuple(np.concatenate(p) for p in parts)
                         if parts[0] else None)
                t0 = time.monotonic()
                # Clamp decoded noise below zero: counts are
                # non-negative, so clamping only moves cells TOWARD
                # the exact value — the stamped bound still holds.
                grid = np.maximum(sp.decode(extra), 0.0)
                r, c = np.nonzero(grid)
                level = Level(zoom,
                              morton_encode_np(r.astype(np.int64),
                                               c.astype(np.int64)),
                              grid[r, c])
                if obs.metrics_enabled():
                    synopsis_metrics.SYNOPSIS_DECODE_SECONDS.observe(
                        time.monotonic() - t0)
                layer.synopses[zoom] = SynopsisView(level, sp.max_err)

    # -- integral pyramids -------------------------------------------------

    def _attach_integrals(self, by_pair: dict, syn_dir: str,
                          delta_dirs: list[str]):
        """Load every readable ``integral-z*.npz`` in ``syn_dir`` onto
        the matching layers (heatmap_tpu_torch.analytics).

        For delta stores the integrals describe the BASE pyramid, so
        the live delta dirs' rows are folded in by recovering the grid
        from the SAT, scatter-adding, and rescanning — an exact
        operation for integer grids, keeping /query answers equal to a
        full recompute over base ⊕ deltas. Unreadable artifacts are
        skipped (/query falls through to exact rows; the recovery
        sweep owns quarantining them)."""
        ints = integral_build.load_integrals(syn_dir)
        if not ints:
            return
        extras: dict[int, list] = {}
        for d in delta_dirs:
            try:
                loaded = LevelArraysSink.load(d)
            except OSError:
                continue
            for zoom, cols in loaded.items():
                if int(zoom) in ints:
                    extras.setdefault(int(zoom), []).append(cols)
        for zoom, pairs in ints.items():
            for ip in pairs:
                layer = by_pair.get((ip.user, ip.timespan))
                if layer is None:
                    continue
                parts = [[], [], []]
                for cols in extras.get(zoom, ()):
                    users = np.asarray(cols["user"], str)
                    tss = np.asarray(cols["timespan"], str)
                    sel = (users == ip.user) & (tss == ip.timespan)
                    if sel.any():
                        parts[0].append(np.asarray(cols["row"],
                                                   np.int64)[sel])
                        parts[1].append(np.asarray(cols["col"],
                                                   np.int64)[sel])
                        parts[2].append(np.asarray(cols["value"],
                                                   np.float64)[sel])
                if parts[0]:
                    ip = ip.with_extras(np.concatenate(parts[0]),
                                        np.concatenate(parts[1]),
                                        np.concatenate(parts[2]))
                layer.integrals[zoom] = ip

    def publish_provisional(self, rows_by: dict) -> int:
        """Early-serving hook (ingest/loop.py): overlay a just-journaled
        micro-batch's coarse cell counts onto the current synopsis
        views, ahead of the exact delta apply.

        ``rows_by`` is ``{(user, timespan): {zoom: (rows, cols,
        values)}}``. Only (pair, zoom) slots that already carry a
        synopsis are touched — the overlay is an exact addition on the
        decoded grid, so the stamped bound is unchanged; the view is
        marked ``stale`` until the exact apply's ``refresh_layers``
        rebuilds the index (which supersedes every provisional view).
        Returns the number of views updated; bumps ``synopsis_epoch``
        so cached synopsis tiles cannot alias the provisional bytes.
        """
        by_pair: dict[tuple, Layer] = {}
        for layer in self._layers.values():
            by_pair.setdefault((layer.user, layer.timespan), layer)
        updated = 0
        per_zoom: dict[int, list] = {}
        for pair, zooms in rows_by.items():
            layer = by_pair.get(tuple(pair))
            if layer is None:
                continue
            for zoom, (r, c, v) in zooms.items():
                view = layer.synopses.get(int(zoom))
                if view is None or not len(np.asarray(r)):
                    continue
                lvl = view.level
                codes = np.concatenate([
                    lvl.codes,
                    morton_encode_np(np.asarray(r, np.int64),
                                     np.asarray(c, np.int64))])
                values = np.concatenate([lvl.values,
                                         np.asarray(v, np.float64)])
                codes, values = _combine_cells(codes, values)
                layer.synopses[int(zoom)] = SynopsisView(
                    Level(zoom, codes, values), view.max_err, stale=True)
                per_zoom.setdefault(int(zoom), []).append(view.max_err)
                updated += 1
        if updated:
            with self._lock:
                self.synopsis_epoch += 1
            for zoom, errs in sorted(per_zoom.items()):
                # bytes=0: an in-memory overlay, no artifact written.
                obs.emit("synopsis_built", zoom=zoom, pairs=len(errs),
                         bytes=0, max_err=float(max(errs)),
                         provisional=True)
        return updated

    def stats(self) -> dict:
        """Small JSON-ready summary for /healthz."""
        return {
            "spec": self.spec,
            "kind": self.kind,
            "generation": self.generation,
            "synopsis_epoch": self.synopsis_epoch,
            "delta_epoch": self.delta_epoch,
            "layers": {
                name: {
                    "user": layer.user,
                    "timespan": layer.timespan,
                    "detail_zooms": layer.detail_zooms,
                    "result_delta": layer.result_delta,
                    "rows": int(sum(len(l) for l in layer.levels.values())),
                    "synopsis_zooms": sorted(layer.synopses),
                    "synopsis_stale": any(v.stale for v in
                                          layer.synopses.values()),
                    "integral_zooms": sorted(layer.integrals),
                }
                for name, layer in sorted(self._layers.items())
            },
        }
