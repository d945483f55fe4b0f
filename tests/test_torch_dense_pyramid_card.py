"""The dense pyramid kernel (``csrc/dense_pyramid.cu``) against its plain
version on the card: every level equal bit for bit, of the same dtype
and shape, contiguous, and one counted launch for each
``KERNEL_LEVELS`` levels, on every pyramid case of
``heatmap_tpu_torch.kernel_cases`` (the bulk step's 8192 x 4096 int32
window with 10 levels, tiles cut ragged, a batch, non-integer float32,
int32 sums that wrap, blocks of a wider raster), on batch slices, and on
the pyramid of the bulk step itself.

Each test carries the ``card`` marker and skips inside the test where
``torch.cuda.is_available()`` is false. The file imports nothing of JAX,
and runs on a card machine without the suite's JAX conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_dense_pyramid_card.py
"""

from __future__ import annotations

import json
import math
import pathlib

import pytest
import torch

from heatmap_tpu_torch import kernel_cases as kc
from heatmap_tpu_torch.ops import pyramid as tpyr

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on a card machine")
    return torch.device("cuda", 0)


def _held_to_plain(raster, levels):
    """Roll ``raster`` up with the kernel and with the plain version;
    assert that every level agrees and return the kernel's launches."""
    want = tpyr._plain(raster, levels)
    before = tpyr.pyramid_from_raster.launches
    got = tpyr.pyramid_from_raster(raster, levels)
    torch.cuda.synchronize()
    launches = tpyr.pyramid_from_raster.launches - before
    assert len(got) == len(want) == levels + 1
    assert got[0] is raster
    for g, w in zip(got[1:], want[1:]):
        assert g.device == w.device and g.dtype == w.dtype
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)
    return launches


def _launches(levels):
    return math.ceil(levels / tpyr.KERNEL_LEVELS)


@pytest.mark.card
@pytest.mark.parametrize("case", kc.PYRAMID_CASES)
def test_kernel_matches_plain_on_the_card(card, case):
    base, index, levels = kc.pyramid_case(case)
    raster = torch.as_tensor(base, device=card)[index]
    assert _held_to_plain(raster, levels) == _launches(levels)


@pytest.mark.card
def test_kernel_on_batch_slices(card):
    base, _, levels = kc.pyramid_case("batch")
    batch = torch.as_tensor(base, device=card)
    # A slice of the batch, one raster of it, and a 4-D batch.
    assert _held_to_plain(batch[1:], levels) == _launches(levels)
    assert _held_to_plain(batch[2], levels) == _launches(levels)
    four = batch.reshape(3, 2, 256, 768)
    assert _held_to_plain(four, levels) == _launches(levels)


@pytest.mark.card
def test_kernel_refuses_what_it_does_not_take(card):
    ints = torch.zeros((4, 8, 8), dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="int32 and float32"):
        tpyr.pyramid_from_raster(ints.double(), 1)
    with pytest.raises(ValueError, match="stride 1"):
        tpyr.pyramid_from_raster(ints.transpose(-1, -2)[..., ::2, :], 1)
    with pytest.raises(ValueError, match="fold into one"):
        tpyr.pyramid_from_raster(
            torch.zeros((2, 3, 8, 8), dtype=torch.int32,
                        device=card).transpose(0, 1), 1)
    before = tpyr.pyramid_from_raster.launches
    with pytest.raises(ValueError, match=r"raster \(4, 3, 4\) not 2x2"):
        tpyr.pyramid_from_raster(ints[:, :6, :], 2)
    # An odd side refuses before any launch; no levels launch nothing.
    doubles = ints.double()
    out = tpyr.pyramid_from_raster(doubles, 0)
    assert len(out) == 1 and out[0] is doubles
    assert tpyr.pyramid_from_raster.launches == before


@pytest.mark.card
def test_bulk_step_pyramid_on_the_kernel(card):
    """One step of the ``geolife-z16.bulk`` cell: its pyramid is the
    kernel's (two launches), equal to the plain version's from the
    step's own raster."""
    from benchmark import generate
    from heatmap_tpu_torch import bench
    from heatmap_tpu_torch.ops.histogram import window_from_bounds

    config = json.loads((ROOT / "benchmark" / "configs" /
                         "geolife-z16.json").read_text())
    w = config["window"]
    window = window_from_bounds(tuple(w["lat"]), tuple(w["lon"]), w["zoom"],
                                align_levels=w["align_levels"],
                                pad_multiple=w["pad_multiple"])
    lat, lon = generate.mixture_points(config["points_per_step"],
                                       config["points"], 2**31 + 7,
                                       "step-input-0", card)
    before = tpyr.pyramid_from_raster.launches
    total, pyr = bench.step(lat, lon, window, config["levels"],
                            config["bin_backend"], proj_dtype=torch.float64)
    assert tpyr.pyramid_from_raster.launches - before == 2
    assert len(pyr) == config["levels"] + 1
    for g, want in zip(pyr[1:], tpyr._plain(pyr[0], config["levels"])[1:]):
        assert torch.equal(g, want)
    assert int(total) == int(pyr[0].sum()) > 0
