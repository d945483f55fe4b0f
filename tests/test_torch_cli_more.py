"""The port's ``stream``, ``merge`` and ``info`` commands, its ``run``
summary and backend flags (``--backend``, ``--device-timeout``,
``--no-x64``, ``--chaos``), the ``parquet:`` source and the ``dir:`` and
``arrays-parquet:`` sinks, and adaptive capacities, on the CPU against
``python -m heatmap_tpu ... --backend cpu``: the same summary lines, the
same PNG trees, blob files and level files byte for byte, and the same
refusals. Both CLIs run in this process unless the test needs a fresh
one (the JAX package's 64-bit mode is process-wide)."""

import csv
import importlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from heatmap_tpu import cli as jcli
from heatmap_tpu import faults as jfaults
from heatmap_tpu.io import sources as jsources
from heatmap_tpu.io.sources import SyntheticSource as JaxSyntheticSource
from heatmap_tpu.ops import pyramid as jpyramid
from heatmap_tpu.pipeline import batch as jbatch
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import devices as tdevices
from heatmap_tpu_torch import faults as tfaults
from heatmap_tpu_torch.io import LevelArraysSink, ParquetSource, open_source
from heatmap_tpu_torch.io import SyntheticSource
from heatmap_tpu_torch.ops import pyramid as tpyramid
from heatmap_tpu_torch.pipeline import batch as tbatch
from heatmap_tpu_torch import native


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    """The JAX reference with its native library. heatmap_tpu.native
    builds at import without a lock, so under ``pytest -n`` on a fresh
    checkout a worker can lose that race and import it without its
    library; it then loads the port's locked build instead (also what
    ``python -m heatmap_tpu`` subprocesses of this module load)."""
    from heatmap_tpu import native as jnative

    if jnative._lib is None:
        path = native.build()
        assert path, "the native library does not build"
        os.environ["HEATMAP_TPU_NATIVE_LIB"] = path
        importlib.reload(jnative)
    assert jnative.available()

REPO = pathlib.Path(__file__).resolve().parent.parent
STREAM = ["--batch-points", "2048", "--interval", "600", "--half-life", "1200",
          "--zoom", "10", "--pixel-delta", "6", "--lat-min", "46",
          "--lat-max", "49", "--lon-min", "-124", "--lon-max", "-120"]
RUN = ["--detail-zoom", "12", "--min-detail-zoom", "6",
       "--timespans", "alltime,month"]
#: The JAX package's keys of the stream summary, in its order.
STREAM_KEYS = ["batches", "stream_seconds", "live_mass", "bounds", "tiles",
               "seconds", "output"]
#: A chaos spec in the grammar of heatmap_tpu/faults/plane.py: fail the
#: first check of the sink.write site once, retry without sleeping.
CHAOS = "seed=7,scale=0,sink.write=1"


@pytest.fixture(autouse=True)
def _disarm_port_faults():
    yield
    tfaults.install(None)


def _tree(root):
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _main(cli, argv, capsys):
    """Run one CLI in process; its last stdout line as JSON."""
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _both(capsys, argv, jax_out, port_out, port_argv=()):
    """One command through both CLIs on the CPU, each to its own output."""
    want = _main(jcli, [*argv, "--backend", "cpu", "--output", jax_out],
                 capsys)
    got = _main(tcli, [*argv, "--backend", "cpu", *port_argv, "--output",
                       port_out], capsys)
    return want, got


def _same_summary(want, got, keys):
    """The port prints the JAX package's keys first, in its order, with
    the same values (the wall time and the output path aside)."""
    assert list(want) == keys
    assert list(got)[:len(keys)] == keys
    for k in keys:
        if k not in ("seconds", "output"):
            assert got[k] == want[k], k


def _stream_both(tmp_path, capsys, argv, name="s", port_argv=()):
    jout, tout = tmp_path / name / "jax", tmp_path / name / "port"
    want, got = _both(capsys, ["stream", *argv], str(jout), str(tout),
                      port_argv)
    _same_summary(want, got, STREAM_KEYS)
    assert _tree(tout) == _tree(jout)
    return want, got, _tree(tout)


def _points_csv(path, n=4000, value=None, seed=5):
    rows = list(JaxSyntheticSource(n=n, seed=seed).rows())
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["latitude", "longitude", "user_id", "source", "timestamp"]
                   + (["value"] if value is not None else []))
        for i, r in enumerate(rows):
            w.writerow([repr(r["latitude"]), repr(r["longitude"]),
                        r["user_id"], r["source"], r["timestamp"] * 1000]
                       + ([value(i)] if value is not None else []))
    return path


# -- stream ---------------------------------------------------------------


def test_stream_decay_and_resume_same_as_jax(tmp_path, capsys):
    """tests/test_cli.py's decay-and-resume run through both CLIs: the
    same summary and tiles, the same checkpoint raster, and a rerun that
    resumes from the final checkpoint and reproduces the live mass."""
    argv = ["--input", "synthetic:20000:4", *STREAM,
            "--checkpoint-every", "3"]
    jck, tck = tmp_path / "jck", tmp_path / "tck"
    want, got, tree = _stream_both(
        tmp_path, capsys, [*argv], port_argv=())  # no checkpoints
    for rerun in range(2):
        jout, tout = tmp_path / f"r{rerun}" / "jax", tmp_path / f"r{rerun}" / "port"
        want = _main(jcli, ["stream", "--backend", "cpu", *argv,
                            "--checkpoint-dir", str(jck), "--output",
                            str(jout)], capsys)
        got = _main(tcli, ["stream", "--backend", "cpu", *argv,
                           "--checkpoint-dir", str(tck), "--output",
                           str(tout)], capsys)
        _same_summary(want, got, STREAM_KEYS)
        assert _tree(tout) == _tree(jout) == tree
        assert got["batches"] >= 9 and got["tiles"] > 0
        assert 0 < got["live_mass"] < 20000
    assert sorted(os.listdir(tck)) == sorted(os.listdir(jck))
    last = sorted(os.listdir(tck))[-1]
    with np.load(tck / last) as t, np.load(jck / last) as j:
        np.testing.assert_array_equal(t["raster"], j["raster"])


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas", "partitioned"])
def test_stream_bin_backend_same_as_jax(tmp_path, capsys, backend):
    """--bin-backend pins the update's binning path; every port backend
    (plain versions on the CPU) gives the JAX auto route's live mass and
    tiles."""
    want, got, _ = _stream_both(
        tmp_path, capsys, ["--input", "synthetic:8000:4", *STREAM],
        port_argv=("--bin-backend", backend))
    assert got["bin_backend"] == ("xla" if backend == "auto" else backend)
    assert got["device"] == "cpu"


def test_stream_weighted_csv_same_as_jax(tmp_path, capsys):
    """--weighted decays weighted mass: value 5 everywhere gives five
    times the counted live mass, in both packages."""
    p = _points_csv(tmp_path / "w.csv", value=lambda i: 5)
    argv = ["--input", f"csv:{p}", *STREAM[2:], "--batch-points", "1000"]
    _, weighted, _ = _stream_both(tmp_path, capsys, [*argv, "--weighted"],
                                  name="w")
    _, counted, _ = _stream_both(tmp_path, capsys, argv, name="c")
    assert weighted["live_mass"] == pytest.approx(5.0 * counted["live_mass"],
                                                  rel=1e-6)
    assert counted["live_mass"] > 0


def test_stream_weighted_integer_values_same_as_jax(tmp_path, capsys):
    p = _points_csv(tmp_path / "v.csv", value=lambda i: i % 37)
    _stream_both(tmp_path, capsys, ["--input", f"csv:{p}", *STREAM,
                                    "--weighted", "--zoom", "12"])


def test_stream_auto_bounds_same_as_jax(tmp_path, capsys):
    p = tmp_path / "sydney.csv"
    rows = ["latitude,longitude,user_id,source,timestamp"]
    rows += [f"{-33.86 + i * 1e-4},{151.20 + i * 1e-4},u,gps,{i}"
             for i in range(300)]
    p.write_text("\n".join(rows) + "\n")
    _, got, _ = _stream_both(tmp_path, capsys, [
        "--input", str(p), "--zoom", "10", "--pixel-delta", "6",
        "--auto-bounds", "--batch-points", "128"])
    assert got["tiles"] >= 1 and got["live_mass"] > 0
    empty = tmp_path / "empty.csv"
    empty.write_text("latitude,longitude,user_id,source,timestamp\n")
    want, got = _both(capsys, ["stream", "--input", str(empty),
                               "--auto-bounds"], "o", "o")
    assert got == want


def test_stream_resumes_a_jax_checkpoint(tmp_path, capsys):
    """The JAX CLI streams the first half of a CSV with a checkpoint dir;
    the port's CLI resumes from it over the whole file, replays the
    source up to the checkpoint, and ends where an uninterrupted JAX run
    ends."""
    full = _points_csv(tmp_path / "full.csv", n=6000, seed=8)
    lines = full.read_text().splitlines(keepends=True)
    prefix = tmp_path / "prefix.csv"
    prefix.write_text("".join(lines[:1 + 3 * 1000]))
    argv = [*STREAM[2:], "--batch-points", "1000"]
    ck = tmp_path / "ck"
    first = _main(jcli, ["stream", "--backend", "cpu", "--input",
                         f"csv:{prefix}", *argv, "--checkpoint-dir", str(ck),
                         "--output", ""], capsys)
    assert first["batches"] == 3
    got = _main(tcli, ["stream", "--backend", "cpu", "--input",
                       f"csv:{full}", *argv, "--checkpoint-dir", str(ck),
                       "--output", str(tmp_path / "port")], capsys)
    want = _main(jcli, ["stream", "--backend", "cpu", "--input",
                        f"csv:{full}", *argv, "--output",
                        str(tmp_path / "jax")], capsys)
    _same_summary(want, got, STREAM_KEYS)
    assert got["batches"] == 6
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


@pytest.mark.parametrize("argv", [
    ["--half-life", "0"],
    ["--zoom", "4"],
    ["--checkpoint-dir", "CK", "--checkpoint-every", "0"],
])
def test_stream_refusals_read_the_same(tmp_path, argv):
    argv = [str(tmp_path / "ck") if a == "CK" else a for a in argv]
    base = ["stream", "--input", "synthetic:100", "--output", str(tmp_path)]
    with pytest.raises(SystemExit) as jerr:
        jcli.main([*base, "--backend", "cpu", *argv])
    with pytest.raises(SystemExit) as terr:
        tcli.main([*base, "--backend", "cpu", *argv])
    assert str(terr.value) == str(jerr.value)
    assert str(terr.value)


def test_stream_output_defaults_under_live_dir(tmp_path, capsys):
    got = _main(tcli, ["stream", "--backend", "cpu", "--input",
                       "synthetic:3000:1", *STREAM, "--live-dir",
                       str(tmp_path / "live")], capsys)
    assert got["output"] == str(tmp_path / "live" / "live_tiles")
    assert got["tiles"] > 0 and (tmp_path / "live" / "live_tiles").is_dir()
    none = _main(tcli, ["stream", "--backend", "cpu", "--input",
                        "synthetic:3000:1", *STREAM, "--output", ""], capsys)
    assert none["tiles"] == 0 and none["live_mass"] == got["live_mass"]


def test_stream_no_x64_projects_in_float32(tmp_path):
    args = tcli.build_parser().parse_args(
        ["stream", "--backend", "cpu", "--input", "synthetic:3000:1",
         *STREAM, "--no-x64", "--output", ""])
    summary, snap, stream = tcli.run_stream_command(args)
    assert stream.config.proj_dtype == torch.float32
    assert summary["batches"] == 2 and snap.sum() > 0


def test_stream_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["stream", "--input", "synthetic:100", "--output",
                   str(tmp_path)])


# -- run: summary (F1) and backend flags (F2) -------------------------------


@pytest.mark.parametrize("kind", ["jsonl", "arrays"])
def test_run_summary_on_stdout_like_jax(tmp_path, capsys, kind):
    target = "blobs.jsonl" if kind == "jsonl" else "levels"
    want, got = _both(
        capsys, ["run", "--input", "synthetic:1200:2", *RUN],
        f"{kind}:{tmp_path / 'jax' / target}",
        f"{kind}:{tmp_path / 'port' / target}")
    keys = ["seconds", "output", "ingest"] + (
        ["blobs"] if kind == "jsonl" else ["levels", "rows"])
    _same_summary(want, got, keys)
    assert list(got)[len(keys):] == ["device", "cascade_backend"]
    assert got["seconds"] == round(got["seconds"], 3)
    assert got["output"] == f"{kind}:{tmp_path / 'port' / target}"


@pytest.mark.parametrize("via", ["flag", "env"])
def test_run_chaos_retries_sink_write(tmp_path, capsys, monkeypatch, via):
    """A chaos spec that fails the arrays sink's first level write once
    arms the port's fault plane from --chaos or $HEATMAP_TPU_CHAOS; the
    write is retried and the level files equal an undisturbed run's."""
    jfaults.parse_spec(CHAOS)  # the JAX package's grammar
    base = ["run", "--backend", "cpu", "--input", "synthetic:1200:2", *RUN]
    _main(tcli, [*base, "--output", f"arrays:{tmp_path / 'clean'}"], capsys)
    assert tfaults.get_plane() is None
    if via == "flag":
        extra = ["--chaos", CHAOS]
    else:
        extra = []
        monkeypatch.setenv(tfaults.ENV_VAR, CHAOS)
    _main(tcli, [*base, *extra, "--output", f"arrays:{tmp_path / 'chaos'}"],
          capsys)
    plane = tfaults.get_plane()
    assert plane is not None and plane.injected == 1
    assert plane.counts() == {"sink.write": 1}
    assert _tree(tmp_path / "chaos") == _tree(tmp_path / "clean")


def test_memory_sink_retries_a_failed_chunk():
    """The memory sink writes in chunks of 16,384 blobs, each under the
    sink.write retry policy: a chunk failed once by the fault plane is
    written again and every blob lands once, the last write of an id
    winning."""
    from heatmap_tpu_torch.io import MemorySink

    tfaults.install_spec(CHAOS)
    records = [(f"u|alltime|{i % 30000}", {"1": i}) for i in range(40000)]
    sink = MemorySink()
    assert sink.write(iter(records)) == 40000
    assert tfaults.get_plane().counts() == {"sink.write": 1}
    assert sink.blobs == {k: json.dumps(v) for k, v in records}


@pytest.mark.parametrize("command", ["run", "merge"])
def test_output_typo_fails_at_parse_time(capsys, command):
    argv = ([command, "--input", "synthetic:10", "--backend", "cpu"]
            if command == "run" else [command, "--inputs", "a.jsonl"])
    with pytest.raises(SystemExit) as err:
        tcli.main([*argv, "--output", "josnl:x"])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert "unrecognized sink spec 'josnl:x'" in msg
    with pytest.raises(SystemExit):
        jcli.main([*argv, "--output", "josnl:x"])
    assert "unrecognized sink spec 'josnl:x'" in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["arrays-synopsis", "arrays-integral",
                                  "cassandra"])
def test_unported_sink_kind_fails_at_parse_time(capsys, tmp_path, kind):
    """Every JAX sink kind parses now. ``arrays-synopsis:`` and
    ``arrays-integral:`` write the JAX run's files (levels plus synopses
    or summed-area tables) byte for byte; ``cassandra:`` without a
    session runs the job and then fails on its first write with the JAX
    run's ``SinkConfigError`` (a process exits 1 on it)."""
    if kind != "cassandra":
        trees = []
        for cli, dev in ((tcli, "--device"), (jcli, "--backend")):
            out = tmp_path / cli.__name__
            assert cli.main(["run", "--input", "synthetic:3000:2", *RUN,
                             dev, "cpu", "--output", f"{kind}:{out}"]) == 0
            summary = json.loads(capsys.readouterr().out.splitlines()[-1])
            assert summary["output"] == f"{kind}:{out}"
            trees.append(_tree(out))
        assert trees[0] == trees[1]
        side = "synopsis-z" if kind == "arrays-synopsis" else "integral-z"
        assert any(name.startswith(side) for name in trees[0])
        return
    from heatmap_tpu.io.sinks import SinkConfigError as JSinkConfigError
    from heatmap_tpu_torch.io.sinks import SinkConfigError

    errors = []
    for cli, dev, exc in ((tcli, "--device", SinkConfigError),
                          (jcli, "--backend", JSinkConfigError)):
        with pytest.raises(exc) as err:
            cli.main(["run", "--input", "synthetic:300:2", *RUN, dev, "cpu",
                      "--output", f"{kind}:"])
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "needs a cassandra-driver session" in errors[0]


@pytest.mark.parametrize("command", ["run", "tiles", "stream", "info"])
def test_backend_flags_on_device_commands(command):
    args = tcli.build_parser().parse_args(
        [command, *([] if command == "info" else ["--input", "x"]),
         "--backend", "tpu", "--device-timeout", "5", "--no-x64",
         "--chaos", CHAOS])
    assert (args.backend, args.no_x64, args.chaos) == ("tpu", True, CHAOS)
    assert args.device_timeout == 5.0
    jargs = jcli.build_parser().parse_args(
        [command, *([] if command == "info" else ["--input", "x"]),
         "--backend", "tpu", "--device-timeout", "5", "--no-x64",
         "--chaos", CHAOS])
    assert {k: getattr(jargs, k) for k in ("backend", "no_x64", "chaos",
                                           "device_timeout")} == \
        {k: getattr(args, k) for k in ("backend", "no_x64", "chaos",
                                       "device_timeout")}


@pytest.mark.parametrize("flags,device", [
    ([], "cuda"), (["--backend", "tpu"], "cuda"), (["--backend", "cpu"], "cpu"),
    (["--device", "cpu"], "cpu"), (["--device", "cuda"], "cuda"),
    (["--backend", "cpu", "--device", "cpu"], "cpu"),
])
def test_device_alias_resolves(flags, device):
    args = tcli.build_parser().parse_args(["tiles", "--input", "x", *flags])
    assert tcli._device(args) == device
    assert args.backend == ("cpu" if device == "cpu" else "tpu")


def test_device_alias_disagreeing_with_backend_is_an_error():
    with pytest.raises(SystemExit, match="disagrees"):
        tcli.main(["run", "--input", "synthetic:10", "--output", "memory:",
                   "--backend", "cpu", "--device", "cuda"])


def test_device_timeout_fails_instead_of_hanging(monkeypatch):
    monkeypatch.setattr(tdevices, "resolve_device", lambda d: None)
    monkeypatch.setattr(torch.cuda, "init", lambda: time.sleep(3))
    args = tcli.build_parser().parse_args(
        ["run", "--input", "x", "--device-timeout", "0.2"])
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="did not initialise within"):
        tcli._init_backend(args)
    assert time.perf_counter() - t0 < 2.5


def test_run_no_x64_ends_like_jax(tmp_path):
    """``run --no-x64``: the composite-key cascade needs 64-bit keys, and
    both packages end with exit code 1 saying so."""
    procs = {}
    for package in ("heatmap_tpu", "heatmap_tpu_torch"):
        procs[package] = subprocess.run(
            [sys.executable, "-m", package, "run", "--backend", "cpu",
             "--no-x64", "--input", "synthetic:200", "--output", "memory:",
             *RUN], cwd=REPO, capture_output=True, text=True, timeout=300)
    for proc in procs.values():
        assert proc.returncode == 1, proc.stderr
        assert "the composite-key cascade needs int64 keys" in proc.stderr
        assert proc.stdout == ""


# -- merge ----------------------------------------------------------------


def test_merge_blob_shards_same_bytes_as_jax(tmp_path, capsys):
    shards = []
    for seed in (1, 2):
        shard = tmp_path / f"blobs.jsonl.p00{seed}"
        _main(jcli, ["run", "--backend", "cpu", "--input",
                     f"synthetic:800:{seed}", *RUN, "--output",
                     f"jsonl:{shard}"], capsys)
        shards.append(str(shard))
    for kind in ("jsonl", "dir"):
        target = "m.jsonl" if kind == "jsonl" else "m"
        want = _main(jcli, ["merge", "--inputs", *shards, "--output",
                            f"{kind}:{tmp_path / 'jax' / target}"], capsys)
        got = _main(tcli, ["merge", "--inputs", *shards, "--output",
                           f"{kind}:{tmp_path / 'port' / target}"], capsys)
        assert list(got) == list(want)
        assert {k: v for k, v in got.items() if k != "output"} == \
            {k: v for k, v in want.items() if k != "output"}
        assert got["blobs"] > 100
        assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_merge_level_dirs_same_bytes_as_jax(tmp_path, capsys):
    dirs = []
    for seed in (3, 4):
        d = tmp_path / f"host{seed}"
        _main(jcli, ["run", "--backend", "cpu", "--input",
                     f"synthetic:800:{seed}", *RUN, "--output",
                     f"arrays:{d}"], capsys)
        dirs.append(str(d))
    want = _main(jcli, ["merge", "--inputs", *dirs, "--output",
                        f"arrays:{tmp_path / 'jax'}"], capsys)
    got = _main(tcli, ["merge", "--inputs", *dirs, "--output",
                       f"arrays:{tmp_path / 'port'}"], capsys)
    assert {k: v for k, v in got.items() if k != "output"} == \
        {k: v for k, v in want.items() if k != "output"}
    assert got["mode"] == "levels" and got["rows"] > 100
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


@pytest.mark.parametrize("case", ["dirs_to_blobs", "mix", "blobs_to_arrays"])
def test_merge_refusals_read_the_same(tmp_path, case):
    d = tmp_path / "d"
    d.mkdir()
    f = tmp_path / "f.jsonl"
    f.write_text("")
    inputs, output = {
        "dirs_to_blobs": ([d, d], "jsonl:out.jsonl"),
        "mix": ([d, f], "arrays:out"),
        "blobs_to_arrays": ([f, f], f"arrays:{tmp_path / 'o'}"),
    }[case]
    argv = ["merge", "--inputs", *map(str, inputs), "--output", output]
    with pytest.raises(SystemExit) as jerr:
        jcli.main(argv)
    with pytest.raises(SystemExit) as terr:
        tcli.main(argv)
    assert str(terr.value) == str(jerr.value)
    assert str(terr.value)


# -- parquet source, arrays-parquet and dir sinks ---------------------------


def _points_parquet(path, n=1500, seed=6, values=False):
    rows = list(JaxSyntheticSource(n=n, seed=seed).rows())
    cols = {
        "latitude": [r["latitude"] for r in rows],
        "longitude": [r["longitude"] for r in rows],
        "user_id": [r["user_id"] for r in rows],
        "source": [r["source"] for r in rows],
        "timestamp": [r["timestamp"] for r in rows],
    }
    if values:
        cols["value"] = [None if i % 10 == 0 else float(i % 13)
                         for i in range(n)]
    pq.write_table(pa.table(cols), path, row_group_size=500)
    return path


def test_parquet_source_same_batches_as_jax(tmp_path):
    path = _points_parquet(tmp_path / "p.parquet", values=True)
    for read_value in (None, False):
        got = list(ParquetSource(str(path), read_value).batches(400))
        want = list(jsources.ParquetSource(str(path), read_value)
                    .batches(400))
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]))
        assert ("value" in got[0]) == (read_value is None)
    for spec in (f"parquet:{path}", str(path), str(tmp_path / "x.pq")):
        assert isinstance(open_source(spec), ParquetSource)


def test_run_parquet_input_same_bytes_as_jax(tmp_path, capsys):
    path = _points_parquet(tmp_path / "p.parquet")
    want, got = _both(capsys, ["run", "--input", f"parquet:{path}", *RUN],
                      f"jsonl:{tmp_path / 'jax.jsonl'}",
                      f"jsonl:{tmp_path / 'port.jsonl'}")
    assert got["blobs"] == want["blobs"] > 100
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes()


def test_run_weighted_parquet_same_bytes_as_jax(tmp_path, capsys):
    path = _points_parquet(tmp_path / "w.parquet", values=True)
    _both(capsys, ["run", "--input", str(path), "--weighted", *RUN],
          f"jsonl:{tmp_path / 'jax.jsonl'}", f"jsonl:{tmp_path / 'port.jsonl'}")
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes()


def test_arrays_parquet_sink_same_as_jax(tmp_path, capsys):
    want, got = _both(capsys, ["run", "--input", "synthetic:1500:3", *RUN],
                      f"arrays-parquet:{tmp_path / 'jax'}",
                      f"arrays-parquet:{tmp_path / 'port'}")
    assert got["levels"] == want["levels"] == 6
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax)
    assert all(name.endswith(".parquet") for name in port)
    assert port == jax
    # Level files read back the same through either package's loader,
    # and match the npz sink's columns.
    from heatmap_tpu.io.sinks import LevelArraysSink as JaxLevelArraysSink

    got = LevelArraysSink.load(str(tmp_path / "port"))
    want = JaxLevelArraysSink.load(str(tmp_path / "jax"))
    _main(tcli, ["run", "--backend", "cpu", "--input", "synthetic:1500:3",
                 *RUN, "--output", f"arrays:{tmp_path / 'npz'}"], capsys)
    npz = LevelArraysSink.load(str(tmp_path / "npz"))
    assert got.keys() == want.keys() == npz.keys()
    for z in want:
        assert got[z].keys() == want[z].keys()
        for k in want[z]:
            np.testing.assert_array_equal(got[z][k], want[z][k])
            np.testing.assert_array_equal(got[z][k], npz[z][k])


def test_dir_sink_same_files_as_jax(tmp_path, capsys):
    want, got = _both(capsys, ["run", "--input", "synthetic:1200:2", *RUN],
                      f"dir:{tmp_path / 'jax'}", f"dir:{tmp_path / 'port'}")
    assert got["blobs"] == want["blobs"] > 100
    tree = _tree(tmp_path / "port")
    assert len(tree) == got["blobs"]
    assert tree == _tree(tmp_path / "jax")


# -- adaptive capacity ------------------------------------------------------


@pytest.mark.parametrize("backend", ["scatter", "partitioned"])
def test_adaptive_capacity_same_blobs(backend):
    cfg = dict(detail_zoom=14, min_detail_zoom=6,
               timespans=("alltime", "month"), cascade_backend=backend)
    want = jbatch.run_job(JaxSyntheticSource(n=3000, seed=9),
                          config=jbatch.BatchJobConfig(
                              detail_zoom=14, min_detail_zoom=6,
                              timespans=("alltime", "month"),
                              adaptive_capacity=True),
                          max_points_in_flight=0)
    plain = tbatch.run_job(SyntheticSource(n=3000, seed=9),
                           config=tbatch.BatchJobConfig(**cfg),
                           device="cpu")
    adaptive = tbatch.run_job(SyntheticSource(n=3000, seed=9),
                              config=tbatch.BatchJobConfig(
                                  **cfg, adaptive_capacity=True),
                              device="cpu")
    assert adaptive == plain == want
    assert len(want) > 100


def test_adaptive_pyramid_shapes_match_jax():
    """The scatter pyramid shrinks each level to the same power of two as
    the JAX package's adaptive pyramid, with the same aggregates; the
    partitioned pyramid cuts its output capacities the same way and
    keeps an overflowed level detectable."""
    rng = np.random.default_rng(2)
    codes = np.sort(rng.integers(0, 1 << 24, 5000)).astype(np.int64)
    jout = jpyramid.pyramid_sparse_morton(codes, levels=8, adaptive=True)
    tout = tpyramid.pyramid_sparse_morton(torch.as_tensor(codes), levels=8,
                                          adaptive=True)
    pout = tpyramid.pyramid_sparse_morton_partitioned(
        torch.as_tensor(codes), levels=8, adaptive=True)
    for (ju, js, jn), (tu, ts, tn), (pu, ps, pn) in zip(jout, tout, pout):
        n = int(jn)
        assert int(tn) == int(pn) == n
        assert tu.shape[0] == ju.shape[0]
        np.testing.assert_array_equal(tu[:n].numpy(), np.asarray(ju)[:n])
        np.testing.assert_array_equal(ts[:n].numpy(), np.asarray(js)[:n])
        np.testing.assert_array_equal(pu[:n].numpy(), np.asarray(ju)[:n])
        np.testing.assert_array_equal(ps[:n].numpy(), np.asarray(js)[:n])
    assert [int(x[0].shape[0]) for x in tout][-1] < 5000
    assert tpyramid.adaptive_keep(torch.tensor(100), 50) is None
    assert tpyramid.adaptive_keep(torch.tensor(100), 4096) == 128
    assert tpyramid.adaptive_keep(torch.tensor(3), 64) is None
    over = tpyramid.pyramid_sparse_morton_partitioned(
        torch.as_tensor(codes), levels=2, capacity=[5000, 10, 5000],
        adaptive=True)
    assert int(over[1][2]) > over[1][0].shape[0]
    assert over[2][0].shape[0] == 5000


# -- info -----------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--no-x64"]])
def test_info_cpu_keys_like_jax(capsys, flags):
    got = _main(tcli, ["info", "--backend", "cpu", *flags], capsys)
    want = _main(jcli, ["info", "--backend", "cpu"], capsys)
    assert list(got) == list(want)
    assert got["backend"] == "cpu" and got["platform"] == "cpu"
    assert got["n_devices"] == 1 and got["n_processes"] == 1
    assert got["x64"] is (not flags)
    assert isinstance(got["native"], bool)


def test_info_without_a_card_reports_json(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = _main(tcli, ["info", "--device-timeout", "5"], capsys)
    assert got["backend"] == "tpu" and got["platform"] == "unavailable"
    assert got["n_devices"] == 0 and "--backend cpu" in got["note"]
