"""Ingest sources: columnar point-batch readers.

Port of the synthetic, CSV, JSONL and Parquet readers of
heatmap_tpu/io/sources.py (HMPB files: io/hmpb.py).
Every source yields columnar batches (dicts of host numpy arrays and
string lists) with the reference's row contract (reference
heatmap.py:25-36): ``latitude``, ``longitude``, ``user_id``, ``source``,
``timestamp``, plus an optional ``value`` weight column. Rows with
``source == "background"`` are dropped by the loader
(pipeline.batch), not here.
"""

from __future__ import annotations

import csv
import dataclasses
import functools
import json
import os
from typing import Iterator

import numpy as np

from heatmap_tpu_torch import faults, native, obs

COLUMNS = ("latitude", "longitude", "user_id", "source", "timestamp")

#: Optional per-point weight column; file sources pass it through when
#: the input names one literally ``value``.
VALUE_COLUMN = "value"

DEFAULT_BATCH = 1 << 20


class ConfigError(RuntimeError, faults.NonRetryable):
    """Deterministic configuration failure (a missing client library,
    environment or spec): a RuntimeError for callers, raised straight through the
    retry policy without burning attempts."""


def _empty_batch():
    return {
        "latitude": np.empty(0, np.float64),
        "longitude": np.empty(0, np.float64),
        "user_id": [],
        "source": [],
        "timestamp": [],
    }


def _finalize_with_value(cols, vals):
    """Columns as a batch, plus the weight column when ``vals`` (per-row
    weights, missing entries already 1.0) is not None."""
    out = {
        "latitude": np.asarray(cols["latitude"], np.float64),
        "longitude": np.asarray(cols["longitude"], np.float64),
        "user_id": list(cols["user_id"]),
        "source": list(cols["source"]),
        "timestamp": list(cols["timestamp"]),
    }
    if vals is not None:
        out[VALUE_COLUMN] = np.asarray(vals, np.float64)
    return out


def _finalize(cols):
    return _finalize_with_value(cols, None)


def _count_rows(kind: str):
    """Decorator for ``batches``: guard the stream with the retry policy
    and count the rows it delivers in
    ``source_rows_read_total{source=<kind>}``.

    Every batch pull runs the ``source.read`` fault check; a transient
    failure (an OSError, a RuntimeError or an injected fault) rebuilds
    the underlying iterator and skips the batches already delivered,
    which is sound because every source iterates deterministically. Rows
    count only for delivered batches, so a replayed prefix is not
    counted twice. Data errors (ValueError etc.) propagate at once.
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, batch_size: int = DEFAULT_BATCH):
            stream = faults.resumable_iter(
                lambda: fn(self, batch_size), site="source.read", key=kind)
            for batch in stream:
                if obs.metrics_enabled():
                    obs.SOURCE_ROWS.inc(len(batch["latitude"]),
                                        source=kind)
                yield batch

        return wrapper

    return deco


class Source:
    """Base: iterable of columnar batches."""

    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        raise NotImplementedError

    def close(self) -> None:
        """Release held resources. Base: no-op."""

    def rows(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        """Row-dict view (for pipeline.batch.load_rows and the
        reference's per-row mappers). Slow path; prefer ``batches``."""
        for b in self.batches(batch_size):
            lat, lon = b["latitude"], b["longitude"]
            for i in range(len(lat)):
                yield {
                    "latitude": float(lat[i]),
                    "longitude": float(lon[i]),
                    "user_id": b["user_id"][i],
                    "source": b["source"][i] if b["source"] else None,
                    "timestamp": b["timestamp"][i] if b["timestamp"] else None,
                }


@dataclasses.dataclass
class SyntheticSource(Source):
    """Clustered synthetic GPS traces (hot-spot mixture over a metro
    area) with a user-id pool exercising every reference routing rule
    (plain ids, ``x``-prefixed excluded ids, ``rt-`` route ids,
    ``background`` rows; reference heatmap.py:28-29,64-70).

    The point stream is the same as heatmap_tpu's SyntheticSource for
    the same ``(n, seed)``."""

    n: int
    seed: int = 0
    n_users: int = 32
    center: tuple = (47.6, -122.3)
    spread: tuple = (0.5, 0.7)
    hotspot_frac: float = 0.25
    background_frac: float = 0.05

    #: Internal generation chunk; the point stream is a pure function of
    #: (seed, chunk index), so any ``batch_size`` yields the same points.
    CHUNK = 1 << 16

    @_count_rows("synthetic")
    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        pending = _empty_batch()
        for chunk in self._chunks():
            for k in COLUMNS:
                if isinstance(pending[k], np.ndarray):
                    pending[k] = np.concatenate([pending[k], chunk[k]])
                else:
                    pending[k] = pending[k] + chunk[k]
            while len(pending["latitude"]) >= batch_size:
                yield {k: v[:batch_size] for k, v in pending.items()}
                pending = {k: v[batch_size:] for k, v in pending.items()}
        if len(pending["latitude"]):
            yield pending

    def _chunks(self) -> Iterator[dict]:
        users = self._user_pool()
        t0 = 1_500_000_000  # fixed epoch base for reproducibility
        emitted = 0
        chunk_idx = 0
        while emitted < self.n:
            m = min(self.n - emitted, self.CHUNK)
            rng = np.random.default_rng([self.seed, chunk_idx])
            hot = rng.random(m) < self.hotspot_frac
            lat = self.center[0] + rng.normal(0, self.spread[0], m)
            lon = self.center[1] + rng.normal(0, self.spread[1], m)
            lat[hot] = self.center[0] + rng.normal(0, 0.02, int(hot.sum()))
            lon[hot] = self.center[1] + rng.normal(0, 0.03, int(hot.sum()))
            uid = rng.integers(0, len(users), m)
            bg = rng.random(m) < self.background_frac
            yield {
                "latitude": lat,
                "longitude": lon,
                "user_id": [users[i] for i in uid],
                "source": np.where(bg, "background", "gps").tolist(),
                "timestamp": (t0 + rng.integers(0, 86400 * 365, m)).tolist(),
            }
            emitted += m
            chunk_idx += 1

    def _user_pool(self):
        users = [f"user-{i}" for i in range(self.n_users)]
        users += [f"x-{i}" for i in range(max(1, self.n_users // 8))]
        users += [f"rt-{i}" for i in range(max(1, self.n_users // 8))]
        return users


@dataclasses.dataclass
class CSVSource(Source):
    """CSV reader with a header row naming (a superset of) COLUMNS.

    Parses with the native C++ decoder (heatmap_tpu_torch.native) where
    the library loads and ``use_native`` is set, with Python's csv
    module otherwise; both yield the same batches.

    ``read_value=None`` (auto) reads a ``value`` weight column when the
    header names one, which routes off the native decoder (it knows the
    reference's columns only) onto the Python reader; ``False`` ignores
    the column and keeps the native route."""

    path: str
    use_native: bool = True
    read_value: bool | None = None

    @_count_rows("csv")
    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        has_value = (self.read_value is not False
                     and self.has_value_column())
        if self.use_native and not has_value and native.available():
            # Mid-stream errors propagate: falling back after yielding
            # would re-read rows and double-count.
            yield from native.parse_csv_batches(self.path, batch_size)
            return
        with open(self.path, newline="") as f:
            reader = csv.DictReader(f)
            cols = {k: [] for k in COLUMNS}
            vals = [] if has_value else None
            for row in reader:
                cols["latitude"].append(float(row["latitude"]))
                cols["longitude"].append(float(row["longitude"]))
                cols["user_id"].append(row.get("user_id", ""))
                cols["source"].append(row.get("source", ""))
                cols["timestamp"].append(row.get("timestamp"))
                if vals is not None:
                    v = row.get(VALUE_COLUMN)
                    vals.append(float(v) if v not in (None, "") else 1.0)
                if len(cols["latitude"]) >= batch_size:
                    yield _finalize_with_value(cols, vals)
                    cols = {k: [] for k in COLUMNS}
                    vals = [] if has_value else None
            if cols["latitude"]:
                yield _finalize_with_value(cols, vals)

    def has_value_column(self) -> bool:
        """Whether the CSV header names a ``value`` weight column."""
        with open(self.path, newline="") as f:
            header = next(csv.reader(f), None)
        return header is not None and VALUE_COLUMN in header


@dataclasses.dataclass
class JSONLSource(Source):
    """One JSON object per line with the reference column names.

    The FIRST data row decides whether the file is weighted
    (``read_value=None``): if it carries ``value``, every batch gets the
    column (missing entries default to 1.0); if it does not, a ``value``
    on a later row raises. ``read_value=True`` forces the weighted
    reading; ``False`` ignores the column."""

    path: str
    read_value: bool | None = None

    @_count_rows("jsonl")
    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        cols = {k: [] for k in COLUMNS}
        weighted = self.read_value  # None -> first data row decides
        vals = []
        line_no = 0
        with open(self.path) as f:
            for line in f:
                line_no += 1
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                v = row.get(VALUE_COLUMN)
                if weighted is None:
                    weighted = v is not None
                elif v is not None and not weighted and self.read_value is None:
                    raise ValueError(
                        f"{self.path}:{line_no}: 'value' appears after "
                        "the first row lacked it; weighted JSONL files "
                        "must carry the column from row 1 (missing "
                        "entries default to 1.0), or pass "
                        "read_value=True to force weighted reading"
                    )
                cols["latitude"].append(float(row["latitude"]))
                cols["longitude"].append(float(row["longitude"]))
                cols["user_id"].append(row.get("user_id", ""))
                cols["source"].append(row.get("source", ""))
                cols["timestamp"].append(row.get("timestamp"))
                if weighted:
                    vals.append(float(v) if v is not None else 1.0)
                if len(cols["latitude"]) >= batch_size:
                    yield _finalize_with_value(cols, vals if weighted else None)
                    cols = {k: [] for k in COLUMNS}
                    vals = []
        if cols["latitude"]:
            yield _finalize_with_value(cols, vals if weighted else None)


@dataclasses.dataclass
class ParquetSource(Source):
    """Parquet reader (pyarrow), batched at row-group granularity.

    A ``value`` weight column in the schema passes through (nulls
    default to 1.0) unless ``read_value=False``."""

    path: str
    read_value: bool | None = None

    @_count_rows("parquet")
    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(self.path)
        for rb in pf.iter_batches(batch_size=batch_size):
            d = rb.to_pydict()
            out = {
                "latitude": np.asarray(d["latitude"], np.float64),
                "longitude": np.asarray(d["longitude"], np.float64),
                "user_id": [str(u) for u in d.get("user_id", [""] * rb.num_rows)],
                "source": [str(s) for s in d.get("source", [""] * rb.num_rows)],
                "timestamp": list(d.get("timestamp", [None] * rb.num_rows)),
            }
            if VALUE_COLUMN in d and self.read_value is not False:
                out[VALUE_COLUMN] = np.asarray(
                    [1.0 if v is None else float(v) for v in d[VALUE_COLUMN]],
                    np.float64,
                )
            yield out


@dataclasses.dataclass
class CassandraConfig:
    """The reference's hard-coded ingest endpoints as config (reference
    heatmap.py:16-23,131-147).

    ``endpoint`` falsy selects the CosmosDB path via env vars, like the
    reference's truthiness test on ``LOCATION_CASSANDRA_ENDPOINT``
    (reference heatmap.py:132)."""

    endpoint: str | None = "10.1.0.11"  # reference heatmap.py:23
    keyspace: str = "rhom"  # reference heatmap.py:137
    table: str = "locations"  # reference heatmap.py:137
    #: Partition-key column(s) for token() predicates. The reference's
    #: table schema is not in the repo (the Spark connector read it from
    #: table metadata), so it is config here.
    partition_keys: tuple = ("user_id",)
    #: Number of token ranges the Murmur3 ring is split into (the
    #: connector's input-split analog and the re-execution unit).
    n_ranges: int = 64
    cosmosdb_host_env: str = "LOCATIONS_COSMOSDB_HOST"  # heatmap.py:141
    cosmosdb_key_env: str = "LOCATIONS_COSMOSDB_AUTH_KEY"  # heatmap.py:142
    cosmosdb_database: str = "locationsdb"  # heatmap.py:144
    cosmosdb_collection: str = "locations"  # heatmap.py:145


#: Murmur3 partitioner token bounds (the Cassandra default ring).
TOKEN_MIN = -(1 << 63)
TOKEN_MAX = (1 << 63) - 1


def token_ranges(n_ranges: int) -> list:
    """Split the Murmur3 ring into ``n_ranges`` contiguous [lo, hi]
    closed intervals covering [TOKEN_MIN, TOKEN_MAX] exactly.

    Pure arithmetic, so a failed range can be re-read by index on any
    host (the re-execution unit the reference got from the Spark
    connector's token-range input splits, reference heatmap.py:137).
    """
    if n_ranges < 1:
        raise ValueError(f"n_ranges must be >= 1, got {n_ranges}")
    span = 1 << 64
    bounds = [TOKEN_MIN + (span * i) // n_ranges for i in range(n_ranges)]
    bounds.append(TOKEN_MAX + 1)
    return [(bounds[i], bounds[i + 1] - 1) for i in range(n_ranges)]


def _check_shard(shard_index: int, shard_count: int):
    # A bad assignment must fail loudly: an out-of-range shard_index
    # would match no ranges and silently ingest nothing.
    if shard_count < 1 or not (0 <= shard_index < shard_count):
        raise ValueError(
            f"invalid shard assignment: shard_index={shard_index} "
            f"shard_count={shard_count} (need 0 <= index < count)"
        )


@dataclasses.dataclass
class CassandraSource(Source):
    """Cassandra ingest (reference get_rows, heatmap.py:131-147).

    Reads the locations table as ``config.n_ranges`` Murmur3 token-range
    scans, each a bounded query ``WHERE token(pk) >= lo AND token(pk) <=
    hi``. The range index is the unit of multi-host sharding
    (``shard_index``/``shard_count`` interleave ranges across hosts) and
    of re-execution: ``range_batches(i)`` re-reads exactly range ``i``
    after a failure; partial sums are pure adds, so recovery re-adds
    that range's points.

    Constructing one needs no client library. ``batches`` uses an
    injected ``session_factory`` (``() -> session``, with
    ``session.execute(cql) -> iterable of rows``, dicts or attribute
    objects, as a cassandra-driver session pages them), and without one
    imports ``cassandra.cluster`` and raises ConfigError when it is
    missing."""

    config: CassandraConfig = dataclasses.field(default_factory=CassandraConfig)
    session_factory: object = None  # () -> session with .execute(cql)
    #: This host's interleaved share of the token ranges: ranges
    #: shard_index, shard_index + shard_count, ...
    shard_index: int = 0
    shard_count: int = 1

    def __post_init__(self):
        _check_shard(self.shard_index, self.shard_count)

    def _session(self):
        cfg = self.config
        if not cfg.endpoint:
            raise ConfigError(
                "no Cassandra endpoint configured — the reference selects "
                "CosmosDB in that case (reference heatmap.py:132,140-146); "
                "use CosmosDBSource (or the cosmosdb: source spec)"
            )
        if self.session_factory is not None:
            return self.session_factory(), None
        try:
            from cassandra.cluster import Cluster
        except ImportError as e:
            raise ConfigError(
                "Cassandra ingest requires the cassandra-driver "
                "package (not baked into this image); pass "
                "session_factory=... or use CSV/JSONL/Parquet sources"
            ) from e
        cluster = Cluster([self.config.endpoint])
        return cluster.connect(), cluster

    def _range_query(self, lo: int, hi: int) -> str:
        cfg = self.config
        pk = ", ".join(cfg.partition_keys)
        return (
            f"SELECT latitude, longitude, user_id, source, timestamp "
            f"FROM {cfg.keyspace}.{cfg.table} "
            f"WHERE token({pk}) >= {lo} AND token({pk}) <= {hi}"
        )

    def my_ranges(self) -> list:
        """(index, (lo, hi)) pairs owned by this shard."""
        return [
            (i, r)
            for i, r in enumerate(token_ranges(self.config.n_ranges))
            if i % self.shard_count == self.shard_index
        ]

    def _scan(self, session, lo, hi, cols, batch_size):
        for row in session.execute(self._range_query(lo, hi)):
            get = (
                row.get
                if isinstance(row, dict)
                else lambda k, r=row: getattr(r, k)
            )
            cols["latitude"].append(float(get("latitude")))
            cols["longitude"].append(float(get("longitude")))
            cols["user_id"].append(get("user_id"))
            cols["source"].append(get("source"))
            cols["timestamp"].append(get("timestamp"))
            if len(cols["latitude"]) >= batch_size:
                yield _finalize(cols)
                for v in cols.values():
                    v.clear()

    @_count_rows("cassandra")
    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        session, cluster = self._session()
        try:
            cols = {k: [] for k in COLUMNS}
            for _, (lo, hi) in self.my_ranges():
                yield from self._scan(session, lo, hi, cols, batch_size)
            if cols["latitude"]:
                yield _finalize(cols)
        finally:
            if cluster is not None:
                cluster.shutdown()

    def range_batches(self, index: int,
                      batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        """Re-read exactly token range ``index`` (re-execution of one
        failed shard)."""
        lo, hi = token_ranges(self.config.n_ranges)[index]
        session, cluster = self._session()
        try:
            cols = {k: [] for k in COLUMNS}
            yield from self._scan(session, lo, hi, cols, batch_size)
            if cols["latitude"]:
                yield _finalize(cols)
        finally:
            if cluster is not None:
                cluster.shutdown()


@dataclasses.dataclass
class CosmosDBSource(Source):
    """CosmosDB ingest, the reference's alternative input (reference
    heatmap.py:140-146: env-var host and key, database ``locationsdb``,
    collection ``locations``, selected when the Cassandra endpoint is
    falsy, heatmap.py:132).

    The collection is scanned per partition key range (CosmosDB's
    physical shard unit, its analog of Cassandra token ranges), so
    ingest shards across hosts (``shard_index``/``shard_count``
    interleave ranges) and a failed range re-reads exactly
    (``range_batches``).

    A ``client_factory`` must be injected: ``client_factory() ->
    client`` where ``client.partition_key_range_ids() -> [str]`` (may be
    ``[None]`` for a single-range collection) and
    ``client.query_items(sql, partition_key_range_id=...) -> iterable of
    row dicts`` with the reference column names. A thin adapter over an
    ``azure.cosmos.ContainerProxy`` satisfies this.
    """

    config: CassandraConfig = dataclasses.field(default_factory=CassandraConfig)
    client_factory: object = None
    shard_index: int = 0
    shard_count: int = 1

    #: The reference reads whole documents; project just the point
    #: columns (SQL API shape).
    QUERY = ("SELECT c.latitude, c.longitude, c.user_id, c.source, "
             "c.timestamp FROM c")

    def __post_init__(self):
        _check_shard(self.shard_index, self.shard_count)

    def _client(self):
        cfg = self.config
        host = os.environ.get(cfg.cosmosdb_host_env)
        key = os.environ.get(cfg.cosmosdb_key_env)
        if self.client_factory is not None:
            return self.client_factory()
        if not host or not key:
            raise ConfigError(
                f"CosmosDB ingest needs ${cfg.cosmosdb_host_env} and "
                f"${cfg.cosmosdb_key_env} (reference heatmap.py:141-142) "
                "or an injected client_factory"
            )
        raise ConfigError(
            "CosmosDB ingest requires the azure-cosmos SDK, which is not "
            "available in this image; inject client_factory=... (see the "
            "class docstring for the adapter contract) or use "
            "CSV/JSONL/Parquet sources"
        )

    def _scan_range(self, client, range_id, cols, batch_size):
        for row in client.query_items(
            self.QUERY, partition_key_range_id=range_id
        ):
            cols["latitude"].append(float(row["latitude"]))
            cols["longitude"].append(float(row["longitude"]))
            cols["user_id"].append(row.get("user_id", ""))
            cols["source"].append(row.get("source", ""))
            cols["timestamp"].append(row.get("timestamp"))
            if len(cols["latitude"]) >= batch_size:
                yield _finalize(cols)
                for v in cols.values():
                    v.clear()

    def my_range_ids(self, client) -> list:
        ids = list(client.partition_key_range_ids())
        return [
            r for i, r in enumerate(ids)
            if i % self.shard_count == self.shard_index
        ]

    @_count_rows("cosmosdb")
    def batches(self, batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        client = self._client()
        cols = {k: [] for k in COLUMNS}
        for range_id in self.my_range_ids(client):
            yield from self._scan_range(client, range_id, cols, batch_size)
        if cols["latitude"]:
            yield _finalize(cols)

    def range_batches(self, range_id,
                      batch_size: int = DEFAULT_BATCH) -> Iterator[dict]:
        """Re-read exactly one partition key range (re-execution of a
        failed ingest shard)."""
        client = self._client()
        cols = {k: [] for k in COLUMNS}
        yield from self._scan_range(client, range_id, cols, batch_size)
        if cols["latitude"]:
            yield _finalize(cols)


def open_source(spec: str, read_value: bool | None = None, **kwargs):
    """Parse a source spec: ``synthetic:N[:seed]``, ``csv:PATH``,
    ``jsonl:PATH``, ``parquet:PATH``, ``hmpb:PATH`` (a file, or a
    directory of ``*.hmpb`` parts), ``cassandra:[ENDPOINT]`` (an empty
    endpoint selects CosmosDB, as the reference does), ``cosmosdb:``, or
    a bare ``.csv``/``.jsonl``/``.ndjson``/``.parquet``/``.pq``/``.hmpb``
    path. ``kwargs`` go to the source's constructor (a
    ``session_factory`` or ``client_factory``, a shard assignment).

    ``read_value`` controls the optional weight column of the CSV, JSONL
    and Parquet sources: None = read it when present, False = ignore
    it."""
    kind, _, rest = spec.partition(":")
    if kind == "hmpb" or (not rest and spec.endswith(".hmpb")):
        from heatmap_tpu_torch.io.hmpb import HMPBDirSource, HMPBSource

        path = rest or spec
        return (HMPBDirSource(path, **kwargs) if os.path.isdir(path)
                else HMPBSource(path, **kwargs))
    if kind == "synthetic":
        parts = rest.split(":") if rest else ["1000000"]
        n = int(parts[0])
        seed = int(parts[1]) if len(parts) > 1 else 0
        return SyntheticSource(n=n, seed=seed, **kwargs)
    if kind == "csv":
        return CSVSource(rest, read_value=read_value, **kwargs)
    if kind == "jsonl":
        return JSONLSource(rest, read_value=read_value, **kwargs)
    if kind == "parquet":
        return ParquetSource(rest, read_value=read_value, **kwargs)
    if kind == "cassandra":
        cfg = CassandraConfig(endpoint=rest or None)
        if not cfg.endpoint:
            # The reference picks CosmosDB when the endpoint constant is
            # falsy (reference heatmap.py:132).
            return CosmosDBSource(config=cfg, **kwargs)
        return CassandraSource(config=cfg, **kwargs)
    if kind == "cosmosdb":
        return CosmosDBSource(**kwargs)
    if spec.endswith(".csv"):
        return CSVSource(spec, read_value=read_value, **kwargs)
    if spec.endswith((".jsonl", ".ndjson")):
        return JSONLSource(spec, read_value=read_value, **kwargs)
    if spec.endswith((".parquet", ".pq")):
        return ParquetSource(spec, read_value=read_value, **kwargs)
    raise ValueError(
        f"unrecognized source spec {spec!r} (synthetic:N[:seed], "
        "csv:PATH, jsonl:PATH, parquet:PATH, hmpb:PATH, "
        "cassandra:[ENDPOINT] or cosmosdb:)"
    )
