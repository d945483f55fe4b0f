"""The port's ``run`` against the JAX CLI's on the JAX mesh and multihost
flags (``--dp-merge``, ``--dp-min-emissions``, ``--spatial-partition``,
``--multihost``, ``--multihost-egress``, ``--heartbeat-deadline``,
``--on-straggler``, ``--elastic-dir``, ``--elastic-hosts``), and the
``arrays-synopsis:`` and ``arrays-integral:`` outputs, on the CPU: the
same flag set, the same refusals with the same messages, and for every
value that runs the plain single-process job, the same summary and the
same output bytes. Values that need ``parallel/`` exit 2 in the port.
Both CLIs run in this process."""

import json
import os
import pathlib

import pytest

from heatmap_tpu import cli as jcli
from heatmap_tpu.io.sinks import per_process_sink_spec as jper_process
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch.io.sinks import per_process_sink_spec

RUN = ["--input", "synthetic:1500:4", "--detail-zoom", "12",
       "--timespans", "alltime,month"]


def _flags(parser, cmd):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {o for a in sub.choices[cmd]._actions for o in a.option_strings}


def test_run_flags_equal_jax():
    """Every flag of the JAX ``run`` parses in the port's, with the same
    choices and defaults; the port adds only its ``--device`` alias."""
    jflags = _flags(jcli.build_parser(), "run")
    tflags = _flags(tcli.build_parser(), "run")
    assert tflags - jflags == {"--device"}
    assert jflags <= tflags
    argv = ["run", "--input", "x"]
    jargs = vars(jcli.build_parser().parse_args(argv))
    targs = vars(tcli.build_parser().parse_args(argv))
    for key in ("dp_merge", "dp_min_emissions", "spatial_partition",
                "multihost", "multihost_egress", "heartbeat_deadline",
                "on_straggler", "elastic_dir", "elastic_hosts"):
        assert targs[key] == jargs[key], key

    def choices(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {o: a.choices for a in sub.choices["run"]._actions
                for o in a.option_strings if a.choices}

    tch, jch = choices(tcli.build_parser()), choices(jcli.build_parser())
    for flag in ("--dp-merge", "--spatial-partition", "--multihost-egress",
                 "--on-straggler"):
        assert tuple(tch[flag]) == tuple(jch[flag]), flag


def _run(cli, argv, out, capsys):
    """(outcome, summary or message, output files) of one ``run``."""
    dev = (["--device", "cpu"] if cli is tcli else ["--backend", "cpu"])
    try:
        rc = cli.main(["run", *RUN, *argv, *dev])
    except SystemExit as e:
        capsys.readouterr()
        return ("exit", e.code, None)
    except ValueError as e:
        capsys.readouterr()
        return ("ValueError", str(e), None)
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("seconds", "device", "cascade_backend"):
        summary.pop(key, None)
    summary["output"] = summary["output"].replace(str(out), "OUT")
    files = {}
    for p in sorted(pathlib.Path(out).parent.rglob("*")):
        if p.is_file() and p.name.startswith(pathlib.Path(out).name):
            files[p.name] = p.read_bytes()
    return ("ok", summary, files)


@pytest.mark.parametrize("flags", [
    [],
    ["--dp-merge", "prefix"],
    ["--dp-merge", "replicated", "--dp-min-emissions", "1000000000"],
    ["--spatial-partition", "morton"],
    ["--spatial-partition", "off", "--data-parallel", "off"],
    ["--multihost"],
    ["--multihost", "--heartbeat-deadline", "5"],
    ["--multihost", "--multihost-egress", "gather"],
    ["--multihost", "--multihost-egress", "sharded"],
    ["--multihost", "--on-straggler", "raise"],
], ids=lambda f: "_".join(f) or "none")
def test_single_process_values_run_the_plain_job(tmp_path, capsys, flags):
    """Values with which the JAX ``run`` runs the plain job on one
    process give its summary and its output bytes (``sharded`` egress
    writes this process's ``.p000`` shard)."""
    got = _run(tcli, [*flags, "--output", f"jsonl:{tmp_path / 't.jsonl'}"],
               tmp_path / "t.jsonl", capsys)
    want = _run(jcli, [*flags, "--output", f"jsonl:{tmp_path / 'j.jsonl'}"],
                tmp_path / "j.jsonl", capsys)
    assert got[0] == "ok" and want[0] == "ok"
    assert got[1] == want[1]
    assert ({k.replace("t.jsonl", "X") for k in got[2]}
            == {k.replace("j.jsonl", "X") for k in want[2]})
    assert list(got[2].values()) == list(want[2].values())
    if "--multihost" in flags:
        assert got[1]["ingest"] == "standard"


@pytest.mark.parametrize("flags", [
    ["--multihost-egress", "sharded"],
    ["--multihost-egress", "gather"],
    ["--heartbeat-deadline", "5"],
    ["--on-straggler", "reassign"],
    ["--elastic-dir", "E"],
    ["--elastic-hosts", "2"],
    ["--multihost", "--on-straggler", "reassign"],
    ["--spatial-partition", "morton", "--data-parallel", "off"],
    ["--dp-min-emissions", "5", "--data-parallel", "off"],
    ["--dp-min-emissions", "-1"],
    ["--multihost", "--fast"],
    ["--multihost", "--checkpoint-dir", "CK"],
    ["--multihost", "--elastic-hosts", "2"],
    ["--multihost", "--elastic-dir", "E"],
    ["--multihost", "--multihost-egress", "gather", "--output", "arrays:A"],
], ids=lambda f: "_".join(f))
def test_refusals_match_jax(tmp_path, capsys, flags):
    """The JAX refusals, with its messages: the config-time ones exit 1
    through SystemExit, the job-time ones raise its ValueError."""
    flags = [str(tmp_path / f) if f in ("E", "CK") else
             f"arrays:{tmp_path / 'A'}" if f == "arrays:A" else f
             for f in flags]
    if "--output" not in flags:
        flags = [*flags, "--output", f"jsonl:{tmp_path / 'o.jsonl'}"]
    got = _run(tcli, flags, tmp_path / "o.jsonl", capsys)
    want = _run(jcli, flags, tmp_path / "o.jsonl", capsys)
    assert got[0] != "ok"
    assert got == want


@pytest.mark.parametrize("flags,env", [
    (["--multihost", "--on-straggler", "reassign", "--elastic-dir", "E"],
     {}),
    (["--multihost", "--on-straggler", "reassign", "--elastic-dir", "E",
      "--output", "arrays:A"], {}),
    (["--multihost"], {"JAX_COORDINATOR_ADDRESS": "localhost:1"}),
    (["--multihost"], {"JAX_NUM_PROCESSES": "2"}),
], ids=["reassign", "reassign_arrays", "coordinator", "processes"])
def test_values_that_need_parallel_exit_2(tmp_path, capsys, monkeypatch,
                                          flags, env):
    """Elastic reassignment and a configured cluster need ``parallel/``:
    the port exits 2 naming ROADMAP Queue 1 item 7 and writes nothing."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    flags = [str(tmp_path / "E") if f == "E" else
             f"arrays:{tmp_path / 'A'}" if f == "arrays:A" else f
             for f in flags]
    if "--output" not in flags:
        flags = [*flags, "--output", f"jsonl:{tmp_path / 'o.jsonl'}"]
    with pytest.raises(SystemExit) as err:
        tcli.main(["run", *RUN, *flags, "--device", "cpu"])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert "not ported yet" in msg and "item 7" in msg
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("spec", ["jsonl:a/b.jsonl", "x.ndjson", "arrays:d",
                                  "arrays-parquet:d", "arrays-synopsis:d",
                                  "arrays-integral:d", "arrays-tilefs:d",
                                  "dir:d", "memory:", "cassandra:"])
@pytest.mark.parametrize("index", [0, 3])
def test_per_process_sink_spec_equal_jax(spec, index):
    assert per_process_sink_spec(spec, index) == jper_process(spec, index)


@pytest.mark.parametrize("kind", ["arrays-synopsis", "arrays-integral"])
def test_run_side_artifact_sinks_equal_jax(tmp_path, capsys, kind):
    """``run --output arrays-synopsis:DIR`` / ``arrays-integral:DIR``
    write the JAX run's files byte for byte, chunked and with
    ``--multihost-egress sharded`` (this process's ``host000/``)."""
    for extra in ([], ["--max-points-in-flight", "500"],
                  ["--multihost", "--multihost-egress", "sharded"]):
        trees = []
        for cli, name in ((tcli, "t"), (jcli, "j")):
            out = tmp_path / f"{name}{len(extra)}"
            outcome = _run(cli, [*extra, "--output", f"{kind}:{out}"],
                           out, capsys)
            assert outcome[0] == "ok", outcome
            trees.append((outcome[1]["levels"], outcome[1]["rows"],
                          {str(p.relative_to(out)): p.read_bytes()
                           for p in sorted(out.rglob("*")) if p.is_file()}))
        assert trees[0] == trees[1]
        prefix = "synopsis-z" if kind == "arrays-synopsis" else "integral-z"
        assert any(os.path.basename(f).startswith(prefix)
                   for f in trees[0][2])
