"""``heatmap_tpu_torch.tools.soak`` on the CPU against ``tools/soak.py``:
each check at the same tiny size, the port's mesh checks on the 8 CPU
shards of the mesh seam and the JAX checks on the 8 virtual devices
``tests/conftest.py`` makes, giving the same result line (levels, rows,
uniques, blobs, stream mass, ``blob_values_checked``, ``kernel_mass``)."""

import json

import pytest

from test_torch_tools import _jax_tool, _reset  # noqa: F401

from heatmap_tpu_torch.parallel.mesh import _lay_shards
from heatmap_tpu_torch.tools import soak

N = 8192


@pytest.mark.parametrize("name", soak.CHECKS)
def test_soak_check_equals_jax(name, tmp_path):
    jtool = _jax_tool("soak")
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    with _lay_shards("cpu", soak.MESH_SHARDS):
        got = soak.FNS[name](N, str(tmp_path / "t"), "cpu")
    fn = getattr(jtool, "check_" + name.replace("-", "_"))
    want = fn(N, str(tmp_path / "j"))
    assert "skipped" not in got
    assert got == want


def test_soak_main_record_and_exit_codes(tmp_path):
    out = tmp_path / "soak.json"
    assert soak.main(["--n", "4096", "--checks", "mesh,weighted", "--tpu",
                      "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert list(doc) == ["results", "device"] and doc["device"] == "cpu"
    mesh, weighted = doc["results"]
    assert list(mesh)[:3] == ["check", "ok", "s"]
    assert mesh["ok"] and mesh["devices"] == soak.MESH_SHARDS
    assert weighted["ok"] and weighted["kernel_points"] == 4096
    with pytest.raises(SystemExit):
        soak.main(["--checks", "mesh,bogus", "--device", "cpu",
                   "--out", str(out)])


def test_soak_failed_check_exits_1(tmp_path, monkeypatch):
    def broken(n, tmp, device):
        raise AssertionError("diverged")

    monkeypatch.setitem(soak.FNS, "mesh", broken)
    out = tmp_path / "soak.json"
    assert soak.main(["--n", "1024", "--checks", "mesh", "--device", "cpu",
                      "--out", str(out)]) == 1
    (line,) = json.loads(out.read_text())["results"]
    assert line == {"check": "mesh", "ok": False,
                    "error": "AssertionError: diverged"}
