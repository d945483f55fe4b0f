"""The reference's own ends in the port against the JAX package's:
``CassandraSource`` (token-range scans), ``CosmosDBSource``
(partition-key ranges), ``CassandraBlobSink`` and ``open_source``/
``open_sink``, with the fakes of ``tests/test_io.py``; the batch job
from a Cassandra source into a Cassandra sink, single-process and over
two gloo processes; ``source.read`` faults retried past; and the CLI's
error paths without a client library."""

import hashlib
import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from heatmap_tpu import faults as jfaults
from heatmap_tpu import io as jio
from heatmap_tpu import obs as jobs
from heatmap_tpu.io import sinks as jsinks
from heatmap_tpu.io import sources as jsources
from heatmap_tpu.pipeline import BatchJobConfig as JConfig
from heatmap_tpu.pipeline import run_job as jrun_job
from heatmap_tpu_torch import faults as tfaults
from heatmap_tpu_torch import io as tio
from heatmap_tpu_torch import obs as tobs
from heatmap_tpu_torch.io import sinks as tsinks
from heatmap_tpu_torch.io import sources as tsources
from heatmap_tpu_torch.pipeline import BatchJobConfig as TConfig
from heatmap_tpu_torch.pipeline import run_job as trun_job

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (sources module, sinks module) of each package.
PACKAGES = [pytest.param((jsources, jsinks), id="jax"),
            pytest.param((tsources, tsinks), id="torch")]

ROWS = [
    {"latitude": 47.6, "longitude": -122.3, "user_id": "alice",
     "source": "gps", "timestamp": 1},
    {"latitude": 47.61, "longitude": -122.31, "user_id": "bob",
     "source": "gps", "timestamp": 2},
    {"latitude": 47.62, "longitude": -122.32, "user_id": "x-9",
     "source": "gps", "timestamp": 3},
    {"latitude": 47.63, "longitude": -122.33, "user_id": "rt-1",
     "source": "background", "timestamp": 4},
]

#: Fixed fake Murmur3 tokens spread over the ring (tests/test_io.py).
_FAKE_TOKENS = {
    "alice": -(1 << 62),
    "bob": -12345,
    "x-9": 1 << 61,
    "rt-1": (1 << 63) - 7,
}

_RANGE = re.compile(r"token\(.*\) >= (-?\d+) AND token\(.*\) <= (-?\d+)")


class _FakeTokenSession:
    """Fake Cassandra session honoring the token-range predicate:
    execute(cql) filters ROWS by each row's fake partition token."""

    def execute(self, q):
        assert "rhom.locations" in q
        m = _RANGE.search(q)
        assert m, f"query missing token-range predicate: {q}"
        lo, hi = int(m.group(1)), int(m.group(2))
        return iter([r for r in ROWS if lo <= _FAKE_TOKENS[r["user_id"]] <= hi])


class _FakeCosmosClient:
    """Two partition key ranges splitting ROWS by row parity."""

    def partition_key_range_ids(self):
        return ["0", "1"]

    def query_items(self, sql, partition_key_range_id=None):
        assert sql.startswith("SELECT c.latitude")
        return iter([dict(r) for i, r in enumerate(ROWS)
                     if str(i % 2) == partition_key_range_id])


def _token(user) -> int:
    return int.from_bytes(hashlib.blake2b(str(user).encode(),
                                          digest_size=8).digest(),
                          "little", signed=True)


class _Table:
    """A synthetic ``rhom.locations`` partitioned by user_id (tokens from
    ``_token``): its sessions answer range scans and store
    ``rhom.heatmaps`` inserts."""

    def __init__(self, n, seed):
        (cols,) = list(tsources.SyntheticSource(n=n, seed=seed).batches(n))
        self.rows = [{"latitude": float(cols["latitude"][i]),
                      "longitude": float(cols["longitude"][i]),
                      "user_id": cols["user_id"][i],
                      "source": cols["source"][i],
                      "timestamp": cols["timestamp"][i]}
                     for i in range(n)]
        self.heatmaps = {}
        self.queries = []

    def session(self):
        table = self

        class _Future:
            def result(self):
                return None

        class _Session:
            def execute(self, q):
                m = _RANGE.search(q)
                lo, hi = int(m.group(1)), int(m.group(2))
                table.queries.append(lo)
                return iter([r for r in table.rows
                             if lo <= _token(r["user_id"]) <= hi])

            def execute_async(self, cql, params):
                assert "INSERT INTO rhom.heatmaps" in cql
                table.heatmaps[params[0]] = params[1]
                return _Future()

        return _Session()


@pytest.fixture(autouse=True)
def _reset():
    yield
    tfaults.install(None)
    jfaults.install(None)
    tobs.enable_metrics(False)
    tobs.get_registry().reset()
    jobs.enable_metrics(False)
    jobs.get_registry().reset()


def _cols(batches):
    """A list of batches as comparable plain lists."""
    return [{k: np.asarray(v).tolist() for k, v in b.items()}
            for b in batches]


def test_open_source_specs_equal_jax():
    for spec in ("cassandra:10.0.0.5", "cassandra:", "cosmosdb:"):
        got = tsources.open_source(spec)
        want = jsources.open_source(spec)
        assert type(got).__name__ == type(want).__name__
        assert (dataclasses_dict(got.config)
                == dataclasses_dict(want.config))
    assert isinstance(tio.open_source("cassandra:10.0.0.5"),
                      tio.CassandraSource)
    assert tio.open_source("cassandra:10.0.0.5").config.endpoint == "10.0.0.5"
    # Keyword arguments reach the source, as in the JAX package.
    src = tio.open_source("cassandra:h", session_factory=_FakeTokenSession,
                          shard_index=1, shard_count=2)
    assert src.shard_index == 1 and src.session_factory is _FakeTokenSession
    assert tio.open_source("synthetic:10:2", n_users=4).n_users == 4
    with pytest.raises(ValueError):
        tio.open_source("nope")


def dataclasses_dict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


def test_token_ranges_equal_jax():
    assert (tsources.TOKEN_MIN, tsources.TOKEN_MAX) == (
        jsources.TOKEN_MIN, jsources.TOKEN_MAX)
    for n in (1, 3, 64, 1000):
        rs = tsources.token_ranges(n)
        assert rs == jsources.token_ranges(n)
        assert rs[0][0] == tsources.TOKEN_MIN
        assert rs[-1][1] == tsources.TOKEN_MAX
        for (lo, hi), (lo2, _) in zip(rs, rs[1:]):
            assert lo <= hi and lo2 == hi + 1
    for mod in (tsources, jsources):
        with pytest.raises(ValueError, match="n_ranges must be >= 1"):
            mod.token_ranges(0)


def test_without_a_client_library_raises_the_jax_error():
    errors = []
    for mod in (tsources, jsources):
        with pytest.raises(mod.ConfigError) as err:
            next(mod.CassandraSource().batches())
        assert isinstance(err.value, RuntimeError)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "cassandra-driver" in errors[0]
    assert issubclass(tsources.ConfigError, tfaults.NonRetryable)
    # No endpoint: the reference picks CosmosDB.
    for mod in (tsources, jsources):
        src = mod.CassandraSource(config=mod.CassandraConfig(endpoint=None),
                                  session_factory=_FakeTokenSession)
        with pytest.raises(mod.ConfigError, match="CosmosDB"):
            next(src.batches())


@pytest.mark.parametrize("mods", PACKAGES)
def test_injected_session_reads_the_table(mods):
    src = mods[0].CassandraSource(session_factory=_FakeTokenSession)
    (b,) = list(src.batches())
    assert sorted(b["user_id"]) == ["alice", "bob", "rt-1", "x-9"]


def test_batches_equal_jax():
    for size in (1, 3, 1 << 20):
        got = tsources.CassandraSource(
            session_factory=_FakeTokenSession).batches(size)
        want = jsources.CassandraSource(
            session_factory=_FakeTokenSession).batches(size)
        assert _cols(got) == _cols(want)


@pytest.mark.parametrize("mods", PACKAGES)
def test_shards_partition_rows(mods):
    seen = []
    for i in range(3):
        src = mods[0].CassandraSource(session_factory=_FakeTokenSession,
                                      shard_index=i, shard_count=3)
        for b in src.batches():
            seen.extend(b["user_id"])
    assert sorted(seen) == ["alice", "bob", "rt-1", "x-9"]


def test_my_ranges_and_range_rereads_equal_jax():
    for k, i in ((1, 0), (3, 2), (64, 5)):
        got = tsources.CassandraSource(shard_index=i, shard_count=k)
        want = jsources.CassandraSource(shard_index=i, shard_count=k)
        assert got.my_ranges() == want.my_ranges()
    src = tsources.CassandraSource(session_factory=_FakeTokenSession)
    jsrc = jsources.CassandraSource(session_factory=_FakeTokenSession)
    seen = []
    for i, (lo, hi) in enumerate(tsources.token_ranges(64)):
        got = _cols(src.range_batches(i))
        assert got == _cols(src.range_batches(i))
        assert got == _cols(jsrc.range_batches(i))
        for b in got:
            for u in b["user_id"]:
                assert lo <= _FAKE_TOKENS[u] <= hi
                seen.append(u)
    assert sorted(seen) == ["alice", "bob", "rt-1", "x-9"]


def test_invalid_shard_assignment_raises_the_jax_error():
    for kwargs in ({"shard_index": 3, "shard_count": 3},
                   {"shard_index": -1}, {"shard_count": 0}):
        errors = []
        for mod in (tsources, jsources):
            for cls in (mod.CassandraSource, mod.CosmosDBSource):
                with pytest.raises(ValueError, match="shard") as err:
                    cls(**kwargs)
                errors.append(str(err.value))
        assert len(set(errors)) == 1


def test_query_text_equal_jax():
    for keys in (("user_id",), ("device_id", "day")):
        got = tsources.CassandraSource(
            config=tsources.CassandraConfig(partition_keys=keys))
        want = jsources.CassandraSource(
            config=jsources.CassandraConfig(partition_keys=keys))
        assert got._range_query(-5, 5) == want._range_query(-5, 5)
    assert "token(device_id, day) >= -5" in got._range_query(-5, 5)
    assert tsources.CosmosDBSource.QUERY == jsources.CosmosDBSource.QUERY


@pytest.mark.parametrize("mods", PACKAGES)
def test_cosmosdb_reads_shards_and_rereads(mods):
    cls = mods[0].CosmosDBSource
    (b,) = list(cls(client_factory=_FakeCosmosClient).batches())
    assert sorted(b["user_id"]) == ["alice", "bob", "rt-1", "x-9"]
    seen = []
    for i in range(2):
        for b in cls(client_factory=_FakeCosmosClient, shard_index=i,
                     shard_count=2).batches():
            seen.extend(b["user_id"])
    assert sorted(seen) == ["alice", "bob", "rt-1", "x-9"]
    src = cls(client_factory=_FakeCosmosClient)
    got = [u for b in src.range_batches("1") for u in b["user_id"]]
    assert got == [u for b in src.range_batches("1") for u in b["user_id"]]
    assert got == [ROWS[1]["user_id"], ROWS[3]["user_id"]]


def test_cosmosdb_batches_and_errors_equal_jax(monkeypatch):
    got = tsources.CosmosDBSource(client_factory=_FakeCosmosClient)
    want = jsources.CosmosDBSource(client_factory=_FakeCosmosClient)
    assert _cols(got.batches(1)) == _cols(want.batches(1))
    assert (got.my_range_ids(_FakeCosmosClient())
            == want.my_range_ids(_FakeCosmosClient()))
    monkeypatch.delenv("LOCATIONS_COSMOSDB_HOST", raising=False)
    monkeypatch.delenv("LOCATIONS_COSMOSDB_AUTH_KEY", raising=False)
    errors = []
    for mod in (tsources, jsources):
        with pytest.raises(mod.ConfigError) as err:
            next(mod.CosmosDBSource().batches())
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "LOCATIONS_COSMOSDB_HOST" in errors[0]
    monkeypatch.setenv("LOCATIONS_COSMOSDB_HOST", "h")
    monkeypatch.setenv("LOCATIONS_COSMOSDB_AUTH_KEY", "k")
    errors = []
    for mod in (tsources, jsources):
        with pytest.raises(mod.ConfigError) as err:
            next(mod.CosmosDBSource().batches())
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "azure-cosmos" in errors[0]


class _FakeFuture:
    def __init__(self, log):
        self.log = log

    def result(self):
        self.log.append("drain")


class _FakeInsertSession:
    def __init__(self):
        self.calls = []
        self.log = []

    def execute_async(self, cql, params):
        self.calls.append((cql, params))
        self.log.append("insert")
        return _FakeFuture(self.log)


RECORDS = [("u1|alltime|3_1_1", {"8_32_32": 2.0}),
           ("u2|alltime|3_1_2", {"8_33_32": 1.0}),
           ("u3|alltime|3_1_3", {"8_34_32": 4.0})]


def test_sink_batches_async_inserts_as_jax():
    seen = []
    for mod in (tsinks, jsinks):
        session = _FakeInsertSession()
        with mod.CassandraBlobSink(session=session, concurrency=2) as sink:
            assert sink.write(RECORDS) == 3
        assert sink._pending == []
        seen.append((session.calls, session.log))
    assert seen[0] == seen[1]
    calls, log = seen[0]
    assert "INSERT INTO rhom.heatmaps" in calls[0][0]
    assert calls[0][1][0] == "u1|alltime|3_1_1"
    assert json.loads(calls[0][1][1]) == {"8_32_32": 2.0}
    assert log == ["insert", "insert", "drain", "drain", "insert", "drain"]


def test_sink_without_session_and_custom_table_as_jax():
    errors = []
    for mod in (tsinks, jsinks):
        with pytest.raises(mod.SinkConfigError) as err:
            mod.CassandraBlobSink().write_one("id", {"t": 1.0})
        assert isinstance(err.value, RuntimeError)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "session" in errors[0]
    assert issubclass(tsinks.SinkConfigError, tfaults.NonRetryable)
    session = _FakeInsertSession()
    sink = tsinks.CassandraBlobSink(session=session, keyspace="ks",
                                    table="hm")
    sink.write_one("a|b|1_0_0", {"2_0_0": 1.0})
    sink.close()
    assert "INSERT INTO ks.hm " in session.calls[0][0]


def test_open_sink_cassandra_equals_jax():
    got, want = tio.open_sink("cassandra:"), jio.open_sink("cassandra:")
    assert isinstance(got, tio.CassandraBlobSink)
    assert (got.keyspace, got.table, got.concurrency, got.session) == (
        want.keyspace, want.table, want.concurrency, want.session)
    assert tsinks.SINK_KINDS == jsinks.SINK_KINDS
    assert tsinks.validate_sink_spec("cassandra:") == "cassandra:"
    assert not hasattr(tsinks, "UNPORTED_SINK_KINDS")


def test_cassandra_job_writes_the_jax_blobs():
    """run_job from a token-range source into the Cassandra sink, in both
    packages: the stored rhom.heatmaps are byte-equal, and equal the
    job over the same columns through memory:."""
    cfg = dict(detail_zoom=12, timespans=("alltime", "month"))
    tables = []
    for mod, run_job, config in ((tsources, trun_job, TConfig(**cfg)),
                                 (jsources, jrun_job, JConfig(**cfg))):
        table = _Table(3000, 4)
        sinks_mod = tsinks if mod is tsources else jsinks
        kw = {"device": "cpu"} if mod is tsources else {}
        with sinks_mod.CassandraBlobSink(session=table.session()) as sink:
            blobs = run_job(mod.CassandraSource(session_factory=table.session),
                            sink, config, batch_size=700, **kw)
        assert blobs and table.heatmaps == blobs
        assert len(table.queries) == 64
        tables.append(table.heatmaps)
    assert tables[0] == tables[1]
    plain = trun_job(tsources.SyntheticSource(n=3000, seed=4), None,
                     TConfig(**cfg), device="cpu")
    assert plain == tables[0]


def test_cosmosdb_job_equals_jax():
    def client():
        table = _Table(2000, 6)

        class _Client:
            def partition_key_range_ids(self):
                return [str(r) for r in range(5)]

            def query_items(self, sql, partition_key_range_id=None):
                return iter([r for r in table.rows
                             if _token(r["user_id"]) % 5
                             == int(partition_key_range_id)])
        return _Client()

    got = trun_job(tsources.CosmosDBSource(client_factory=client), None,
                   TConfig(detail_zoom=11), device="cpu")
    want = jrun_job(jsources.CosmosDBSource(client_factory=client), None,
                    JConfig(detail_zoom=11))
    assert got and got == want


def test_rows_counted_and_reads_retried_as_jax():
    """source_rows_read_total{source} counts delivered rows; a
    source.read fault rebuilds the stream past what was delivered, the
    same batches come out, and the fault and retry counters equal the
    JAX package's."""
    spec = "seed=7,scale=0,source.read=2x3"
    table = _Table(1000, 2)
    got_batches, counters = [], []
    for mod, faults, obs in ((tsources, tfaults, tobs),
                             (jsources, jfaults, jobs)):
        obs.get_registry().reset()
        obs.enable_metrics(True)
        faults.install_spec(spec)
        try:
            got_batches.append(_cols(mod.CassandraSource(
                session_factory=table.session).batches(100)))
            cos = list(mod.CosmosDBSource(
                client_factory=_FakeCosmosClient).batches())
        finally:
            faults.install(None)
        counters.append((obs.SOURCE_ROWS.samples(),
                         obs.FAULTS_INJECTED.samples(),
                         obs.IO_RETRIES.samples()))
        assert sum(len(b["latitude"]) for b in cos) == len(ROWS)
        obs.enable_metrics(False)
    assert got_batches[0] == got_batches[1]
    assert sum(len(b["latitude"]) for b in got_batches[0]) == 1000
    assert counters[0] == counters[1]
    rows, injected, retries = counters[0]
    assert rows == {("cassandra",): 1000, ("cosmosdb",): len(ROWS)}
    assert injected[("source.read",)] == 2 == retries[("source.read",)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: One host of a 2-process job: a Cassandra source over the test's
#: table, sharded by run_job_multihost; prints the token-range lows it
#: scanned and the gathered blobs.
_CHILD = """
import json, sys
sys.path.insert(0, {tests!r})
from test_torch_cassandra import _Table
from heatmap_tpu_torch import parallel
from heatmap_tpu_torch.io import CassandraSource
from heatmap_tpu_torch.parallel import run_job_multihost
from heatmap_tpu_torch.pipeline import BatchJobConfig

parallel.initialize()
table = _Table(2000, 5)
blobs = run_job_multihost(CassandraSource(session_factory=table.session),
                          None, BatchJobConfig(detail_zoom=10),
                          batch_size=500, device="cpu")
print(json.dumps({{"lows": table.queries, "blobs": blobs}}))
"""


def test_two_process_job_reads_the_two_shard_views():
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ,
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                   PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             _CHILD.format(tests=str(ROOT / "tests"))],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranges = [lo for lo, _ in tsources.token_ranges(64)]
    for rank, out in enumerate(outs):
        assert out["lows"] == ranges[rank::2]
    want = jrun_job(jsources.SyntheticSource(n=2000, seed=5), None,
                    JConfig(detail_zoom=10), batch_size=500)
    # The gather merges the hosts' blobs: equal counts, key order aside
    # (as tests/test_torch_multihost.py compares them).
    for out in outs:
        assert ({k: json.loads(v) for k, v in out["blobs"].items()}
                == {k: json.loads(v) for k, v in want.items()})


def _cli(package, *argv):
    dev = ["--device", "cpu"] if package == "heatmap_tpu_torch" else [
        "--backend", "cpu"]
    return subprocess.run(
        [sys.executable, "-m", package, "run", *argv, *dev],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))


@pytest.mark.parametrize("argv,error", [
    (["--input", "cassandra:10.0.0.1", "--output", "memory:"],
     "ConfigError"),
    (["--input", "synthetic:300:1", "--detail-zoom", "10", "--output",
      "cassandra:"], "SinkConfigError"),
], ids=["source", "sink"])
def test_cli_error_paths_equal_jax(argv, error):
    got = _cli("heatmap_tpu_torch", *argv)
    want = _cli("heatmap_tpu", *argv)
    assert got.returncode == want.returncode == 1
    last = [r.stderr.strip().splitlines()[-1] for r in (got, want)]
    assert last[0].startswith("heatmap_tpu_torch.io.")
    assert last[1].startswith("heatmap_tpu.io.")
    assert f"{error}: " in last[0]
    assert last[0].split(f"{error}: ", 1)[1] == last[1].split(
        f"{error}: ", 1)[1]
