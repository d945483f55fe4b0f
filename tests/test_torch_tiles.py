"""The ``tiles`` command and its PNG egress on the CPU: heatmap_tpu's
``tiles --backend cpu`` and the port's ``tiles --device cpu`` on the same
inputs write the same z/x/y tree, name for name and byte for byte (f64
projection, no splat); with ``--splat`` no pixel differs by more than one
level. The PNG encoder and tile sink are held byte-identical directly,
the CLI refusals read the same, and the headline twin runs end to end."""

import csv
import json
import pathlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from heatmap_tpu import cli as jcli
from heatmap_tpu.io import png as jpng
from heatmap_tpu.io.sinks import PNGTileSink as JaxPNGTileSink
from heatmap_tpu.ops import histogram as jh
from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import interop
from heatmap_tpu_torch.io import PNGTileSink
from heatmap_tpu_torch.io import png as tpng

REPO = pathlib.Path(__file__).resolve().parent.parent


def _tree(root):
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _run_both(tmp_path, argv, port_extra=()):
    """Run ``tiles`` through both CLIs in this process; return both trees
    and the port's printed summary."""
    jout, tout = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["tiles", "--backend", "cpu", *argv, "--output",
                      str(jout)]) == 0
    assert tcli.main(["tiles", "--device", "cpu", *argv, *port_extra,
                      "--output", str(tout)]) == 0
    return _tree(jout), _tree(tout)


def _weighted_csv(path, n=4000, seed=0, fractional=False):
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["latitude", "longitude", "user_id", "source",
                    "timestamp", "value"])
        for i in range(n):
            v = (rng.random() * 20) if fractional else rng.integers(0, 50)
            w.writerow([47.6 + rng.normal(0, 0.3), -122.3 + rng.normal(0, 0.4),
                        f"user-{i % 7}", "background" if i % 50 == 0 else "gps",
                        1_500_000_000 + i, v])
    return path


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas", "partitioned"])
def test_tiles_synthetic_byte_identical(tmp_path, backend):
    """Default flags (z16, 1792x1280 window) on synthetic:20000; every
    port backend (plain versions on the CPU) against the JAX scatter."""
    want, got = _run_both(tmp_path, ["--input", "synthetic:20000"],
                          ("--bin-backend", backend))
    assert len(want) > 10
    assert got.keys() == want.keys()
    assert got == want


@pytest.mark.parametrize("fractional", [False, True])
def test_tiles_weighted_csv_byte_identical(tmp_path, fractional):
    path = _weighted_csv(tmp_path / "pts.csv", fractional=fractional)
    want, got = _run_both(tmp_path, ["--input", f"csv:{path}", "--weighted",
                                     "--zoom", "14", "--pixel-delta", "6"])
    assert len(want) > 3
    assert got == want


def test_tiles_auto_bounds_and_small_window_byte_identical(tmp_path):
    want, got = _run_both(tmp_path / "a", ["--input", "synthetic:6000:4",
                                           "--auto-bounds", "--zoom", "13"])
    assert want and got == want
    # A one-tile window (256 x 256 cells): "auto" on the card would take
    # the histogram kernel; here the port's plain version runs.
    want, got = _run_both(
        tmp_path / "b", ["--input", "synthetic:6000:4", "--lat-min", "47.1",
                         "--lat-max", "47.95", "--lon-min", "-122.33",
                         "--lon-max", "-121.0"], ("--bin-backend", "pallas"))
    assert len(want) == 1 and got == want


def _pixels(png):
    """RGBA pixels of an encoder-written PNG (filter 0 on every line)."""
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(png):
        (length,) = struct.unpack(">I", png[pos:pos + 4])
        tag = png[pos + 4:pos + 8]
        body = png[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 4).astype(np.int16)


def test_tiles_splat_within_one_level(tmp_path):
    want, got = _run_both(tmp_path, ["--input", "synthetic:20000", "--zoom",
                                     "14", "--pixel-delta", "6", "--splat",
                                     "9", "--sigma", "1.5"])
    assert len(want) > 3 and got.keys() == want.keys()
    for name in want:
        diff = np.abs(_pixels(got[name]) - _pixels(want[name]))
        assert diff.max() <= 1, name


def test_tiles_f32_projection_same_tiles(tmp_path, capsys):
    """``--no-x64`` projects in float32 on both sides; their f32 functions
    may round a point across a row edge, so the tile set is compared."""
    want, got = _run_both(tmp_path, ["--input", "synthetic:20000",
                                     "--no-x64"])
    assert len(want) > 10 and got.keys() == want.keys()


@pytest.mark.parametrize("argv", [
    ["--zoom", "5"],
    ["--splat", "4"],
    ["--splat", "-3"],
    ["--sigma", "0"],
    ["--weighted"],
])
def test_tiles_refusals_read_the_same(tmp_path, argv):
    base = ["tiles", "--input", "synthetic:500", "--output", str(tmp_path)]
    with pytest.raises(SystemExit) as jerr:
        jcli.main([*base, "--backend", "cpu", *argv])
    with pytest.raises(SystemExit) as terr:
        tcli.main([*base, "--device", "cpu", *argv])
    assert str(terr.value) == str(jerr.value)
    assert str(terr.value)


def test_tiles_empty_input_and_default_device(tmp_path, capsys, monkeypatch):
    path = tmp_path / "empty.csv"
    path.write_text("latitude,longitude,user_id,source,timestamp,value\n")
    assert tcli.main(["tiles", "--device", "cpu", "--input", f"csv:{path}",
                      "--weighted", "--output", str(tmp_path / "t")]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"tiles": 0, "output": str(tmp_path / "t")}
    # The card by default, with no quiet fallback to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["tiles", "--input", "synthetic:10", "--output",
                   str(tmp_path / "u")])


@pytest.mark.parametrize("log_scale,vmax", [(True, None), (False, None),
                                            (True, 40.0), (False, 7.0)])
def test_png_encoder_byte_identical(log_scale, vmax):
    rng = np.random.default_rng(12)
    raster = (rng.random((32, 48)) < 0.3) * rng.integers(1, 100, (32, 48))
    assert tpng.raster_to_png(raster, log_scale=log_scale, vmax=vmax) == \
        jpng.raster_to_png(raster, log_scale=log_scale, vmax=vmax)
    for img in (raster.astype(np.uint8), np.zeros((3, 5, 3), np.uint8)):
        assert tpng.png_bytes(img) == jpng.png_bytes(img)
    with pytest.raises(ValueError, match="uint8"):
        tpng.png_bytes(raster.astype(np.int32))


def test_png_tile_sink_byte_identical(tmp_path):
    window = jh.Window(zoom=10, row0=64, col0=128, height=64, width=96)
    rng = np.random.default_rng(13)
    raster = (rng.random((64, 96)) < 0.05) * rng.integers(1, 9, (64, 96))
    raster[:32, 32:64] = 0  # one empty tile is skipped
    jn = JaxPNGTileSink(str(tmp_path / "j"), pixel_delta=5).write_window(
        raster, window)
    tn = PNGTileSink(str(tmp_path / "t"), pixel_delta=5).write_window(
        interop.raster_to_numpy(torch.as_tensor(raster)),
        interop.window_from_fields(10, 64, 128, 64, 96))
    assert tn == jn == 5
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    bad = interop.window_from_fields(10, 65, 128, 64, 96)
    with pytest.raises(ValueError, match="align to tile size"):
        PNGTileSink(str(tmp_path / "x"), pixel_delta=5).write_window(raster,
                                                                     bad)


def test_headline_twin_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "heatmap_tpu_torch.bench", "--device", "cpu",
         "--n", "20000", "--steps", "2", "--baseline-n", "4096"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["unit"] == "points/sec" and rec["value"] > 0
    assert rec["device"] == "cpu" and rec["bin_backend_resolved"] == "xla"
    assert rec["window"] == [4096, 4096] and rec["points"] == 20000
    assert rec["launches_per_step"] == 0 and rec["total"] > 0
