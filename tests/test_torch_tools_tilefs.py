"""``heatmap_tpu_torch.tools.tilefs_convert`` on the CPU against
``tools/tilefs_convert.py``: each store kind converted on two copies of
one store, the same summary keys, files and bytes, and the same
``tilefs-z*.bin`` (and, with ``--out``, npz level) bytes."""

import contextlib
import io
import json
import shutil

import pytest

from test_torch_tools import _jax_tool, _reset  # noqa: F401

from heatmap_tpu_torch.tools import tilefs_convert

CONFIG = dict(detail_zoom=10, min_detail_zoom=6, result_delta=2)


def _job(spec, sink_spec):
    from heatmap_tpu_torch.io import open_sink, open_source
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job

    with open_sink(sink_spec) as sink:
        run_job(open_source(spec), sink, BatchJobConfig(**CONFIG),
                device="cpu")


def _store(kind, root):
    """A small store of ``kind`` under ``root``; returns its path."""
    if kind == "arrays":
        _job("synthetic:3000:1", f"arrays:{root}/s")
    elif kind == "hosts":
        for i in range(2):
            _job(f"synthetic:2000:{i}", f"arrays:{root}/s/host{i}")
    elif kind == "delta":
        from heatmap_tpu_torch import delta
        from heatmap_tpu_torch.io import open_source
        from heatmap_tpu_torch.pipeline import BatchJobConfig

        delta.apply_batch(f"{root}/s", open_source("synthetic:3000:2"),
                          BatchJobConfig(**CONFIG), device="cpu")
        delta.compact(f"{root}/s", retention=0)
    elif kind == "jsonl":
        _job("synthetic:2000:3", f"jsonl:{root}/s.jsonl")
        return f"{root}/s.jsonl"
    else:
        _job("synthetic:2000:4", f"dir:{root}/s")
    return f"{root}/s"


def _files(path):
    return {p.relative_to(path).as_posix(): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kind,spec_kind,extra", [
    ("arrays", "arrays", ["--verify"]),
    ("hosts", "arrays", []),
    ("delta", "delta", ["--verify"]),
    ("jsonl", "jsonl", ["--out"]),
    ("dir", "dir", ["--out", "--no-levels"]),
])
def test_tilefs_convert_twin_equals_jax_tool(tmp_path, kind, spec_kind,
                                             extra):
    src = _store(kind, tmp_path / "src")
    jtool = _jax_tool("tilefs_convert")
    outs = {}
    for side in ("t", "j"):
        base = tmp_path / side
        base.mkdir()
        copy = str(base / "store")
        (shutil.copy if kind == "jsonl" else shutil.copytree)(src, copy)
        argv = [f"{spec_kind}:{copy}"]
        for flag in extra:
            argv += [flag, str(base / "out")] if flag == "--out" else [flag]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            if side == "t":
                rc = tilefs_convert.main([
                    *argv, "--record", str(tmp_path / "record.json")])
            else:
                rc = jtool.main(argv)
        assert rc == 0, printed.getvalue()
        text = printed.getvalue()
        outs[side] = (json.loads(text[:text.index("\n}") + 2]), base)
    (got, tbase), (want, jbase) = outs["t"], outs["j"]
    assert list(got) == [*list(want), "device"] and got["device"] == "host"
    assert list(want)[:5] == list(tilefs_convert.SUMMARY_KEYS)
    for key in ("kind", "files", "bytes"):
        assert got[key] == want[key], key
    assert got["files"] and all(f.startswith("tilefs-z")
                                for f in got["files"])
    if "--verify" in extra:
        assert got["verified"] is want["verified"] is True
    assert json.loads((tmp_path / "record.json").read_text()) == got
    tfiles, jfiles = _files(tbase), _files(jbase)
    assert tfiles.keys() == jfiles.keys()
    for name in tfiles:
        if "tilefs-z" in name or name.startswith("out/"):
            assert tfiles[name] == jfiles[name], name


def test_tilefs_convert_refusals_match_jax(tmp_path):
    jtool = _jax_tool("tilefs_convert")
    src = _store("jsonl", tmp_path)
    for argv in ([f"jsonl:{src}"], [f"delta:{tmp_path}/empty"]):
        (tmp_path / "empty").mkdir(exist_ok=True)
        with pytest.raises(SystemExit) as got:
            tilefs_convert.main(argv)
        with pytest.raises(SystemExit) as want:
            jtool.main(argv)
        assert str(got.value) == str(want.value)
