"""Every value of the mesh flags through the port's CLI against the JAX
CLI's, on the CPU: ``--data-parallel`` and ``--dispatch`` on ``run``,
``update``, ``ingest`` and ``writeplane``, and ``--dp-merge`` and
``--spatial-partition`` on ``run``. The JAX CLI runs on the conftest's 8
virtual CPU devices, the port's on ``force_cpu_devices(8)``; each pair
writes the same output bytes (delta stores and planes as their
determined files) and prints the same summary."""

import json

import pytest

from heatmap_tpu import cli as jcli
from heatmap_tpu.pipeline import bucketing as jbucketing
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch.parallel import mesh as tmesh
from heatmap_tpu_torch.pipeline import bucketing as tbucketing
from test_torch_cli_update import _tree
from test_torch_writeplane_cli import _plane_files


@pytest.fixture(autouse=True)
def _cpu8():
    prev = tmesh._virtual
    tmesh.force_cpu_devices(8)
    yield
    tmesh._restore_devices(prev)


MESH_VALUES = [
    ["--data-parallel", "auto"],
    ["--data-parallel", "on"],
    ["--data-parallel", "off"],
    ["--data-parallel", "on", "--dispatch", "auto"],
    ["--data-parallel", "on", "--dispatch", "gspmd"],
    ["--data-parallel", "on", "--dispatch", "shard_map"],
]
RUN_VALUES = MESH_VALUES + [
    ["--data-parallel", "on", "--dp-merge", "replicated"],
    ["--data-parallel", "on", "--dp-merge", "prefix"],
    ["--data-parallel", "on", "--spatial-partition", "auto"],
    ["--data-parallel", "on", "--spatial-partition", "morton"],
    ["--data-parallel", "on", "--spatial-partition", "off"],
    ["--data-parallel", "on", "--spatial-partition", "morton",
     "--dispatch", "shard_map"],
]


def _ids(flags):
    return "_".join(f.lstrip("-") for f in flags)


def _summary(text):
    out = json.loads(text.strip().splitlines()[-1])
    for key in ("seconds", "device", "cascade_backend"):
        out.pop(key, None)
    return out


def _both(argv_for, capsys, tmp_path):
    """Run the port then the JAX CLI; returns their summaries."""
    outs = []
    for cli, name, dev in ((tcli, "t", ["--device", "cpu"]),
                           (jcli, "j", ["--backend", "cpu"])):
        (tbucketing if cli is tcli else jbucketing).reset_cache_stats()
        assert cli.main([*argv_for(tmp_path / name), *dev]) == 0
        s = _summary(capsys.readouterr().out)
        outs.append(json.loads(json.dumps(s).replace(str(tmp_path / name),
                                                     "ROOT")))
    return outs


@pytest.mark.parametrize("flags", RUN_VALUES, ids=_ids)
def test_run_mesh_flags_equal_jax(tmp_path, capsys, flags):
    got, want = _both(lambda r: [
        "run", "--input", "synthetic:2500:4", "--detail-zoom", "11",
        "--timespans", "alltime,month", "--output", f"jsonl:{r}.jsonl",
        *flags], capsys, tmp_path)
    assert got == want
    assert ((tmp_path / "t.jsonl").read_bytes()
            == (tmp_path / "j.jsonl").read_bytes())


@pytest.mark.parametrize("flags", MESH_VALUES, ids=_ids)
def test_update_mesh_flags_equal_jax(tmp_path, capsys, flags):
    got, want = _both(lambda r: [
        "update", "--journal", str(r), "--input", "synthetic:1500:2",
        "--detail-zoom", "10", "--compact-after", "0", *flags],
        capsys, tmp_path)
    assert got == want
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


@pytest.mark.parametrize("flags", MESH_VALUES, ids=_ids)
def test_ingest_mesh_flags_equal_jax(tmp_path, capsys, flags):
    got, want = _both(lambda r: [
        "ingest", "--journal", str(r), "--input", "synthetic:2000:5",
        "--detail-zoom", "10", "--micro-batch", "700", *flags],
        capsys, tmp_path)
    # max_queue_depth is the reader thread's high-water mark, which
    # varies from run to run in either package; the queue's depth (4)
    # plus the tick in hand bounds it. Every other key is equal.
    for v in (got.pop("max_queue_depth"), want.pop("max_queue_depth")):
        assert 1 <= v <= 4 + 1, v
    assert got == want
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


@pytest.mark.parametrize("flags", MESH_VALUES, ids=_ids)
def test_writeplane_mesh_flags_equal_jax(tmp_path, capsys, flags):
    got, want = _both(lambda r: [
        "writeplane", "--root", str(r), "--input", "synthetic:1500:7",
        "--detail-zoom", "10", "--micro-batch", "500", "--writers", "2",
        *flags], capsys, tmp_path)
    # Publishes, and so epochs, follow the pump threads' timing in
    # either package (test_torch_writeplane_cli.py).
    timing = ("lag_p50_s", "publishes")
    for s in (got, want):
        s.pop("epoch")
        s["runs"] = [{a: b for a, b in r.items() if a not in timing}
                     for r in s["runs"]]
    assert got == want
    assert (_plane_files(str(tmp_path / "t"))
            == _plane_files(str(tmp_path / "j")))
