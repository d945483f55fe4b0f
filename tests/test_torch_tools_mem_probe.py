"""``heatmap_tpu_torch.tools.mem_probe`` on the CPU against
``tools/mem_probe.py`` at a tiny size: the same HMPB bytes, the JAX
line keys per mode, the same rows from the twin's ``ram`` and ``spill``
children and the JAX tool's ``ram`` child, and one real fleet's Pss
line (one backend process)."""

import json
import os
import pathlib

from test_torch_tools import _jax_tool, _reset  # noqa: F401

from heatmap_tpu_torch.tools import mem_probe

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_mem_probe_twin_equals_jax_tool(tmp_path, monkeypatch):
    n, chunk = 20_000, 8_000
    jtool = _jax_tool("mem_probe")
    paths = [tmp_path / "t.hmpb", tmp_path / "j.hmpb"]
    mem_probe.build_points(str(paths[0]), n)
    jtool.build_points(str(paths[1]), n)
    assert paths[0].read_bytes() == paths[1].read_bytes()

    out = tmp_path / "t.json"
    assert mem_probe.main(["--n", str(n), "--chunk", str(chunk),
                           "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert list(doc) == ["results", "device"] and doc["device"] == "cpu"
    ram, spill = doc["results"]
    for line in (ram, spill):
        assert list(line) == list(mem_probe.MODE_KEYS)
        assert line["n"] == n and line["chunks"] == 3
    assert (ram["mode"], spill["mode"]) == ("ram", "spill")

    monkeypatch.chdir(ROOT)  # the JAX child imports from "."
    work = tmp_path / "jwork"
    work.mkdir()
    want = jtool.run_mode(str(paths[1]), "ram", chunk, str(work))
    assert list(want) == list(mem_probe.MODE_KEYS)[:5]
    assert ram["rows"] == spill["rows"] == want["rows"] > 0


def test_mem_probe_fleet_rss_one_backend(tmp_path):
    from heatmap_tpu_torch.io import open_sink, open_source
    from heatmap_tpu_torch.pipeline import BatchJobConfig, run_job

    levels = tmp_path / "levels"
    with open_sink(f"arrays:{levels}") as sink:
        run_job(open_source("synthetic:3000:5"), sink,
                BatchJobConfig(detail_zoom=10, min_detail_zoom=6),
                device="cpu")
    out = tmp_path / "fleet.json"
    assert mem_probe.main(["--fleet-rss", f"arrays:{levels}", "--fleet-n",
                           "1", "--fleet-tiles", "8", "--device", "cpu",
                           "--out", str(out)]) == 0
    (line,) = json.loads(out.read_text())["results"]
    assert list(line) == ["leg", "spec", "n", "paths", "total_mb",
                          "per_backend_mb", "source"]
    assert line["leg"] == "mapped" and line["n"] == 1
    assert line["paths"] == 8 and len(line["per_backend_mb"]) == 1
    jtool = _jax_tool("mem_probe")
    assert mem_probe.pss_kb(os.getpid())[1] == jtool.pss_kb(os.getpid())[1]
