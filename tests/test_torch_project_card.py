"""The fused float64 projection kernel (``csrc/project_mercator.cu``)
against its plain version on the card: rows, columns and validity equal
bit for bit, the same lanes rechecked on the host, and one counted
launch per call with lanes (two where the list of flagged lanes
overflowed, none for an empty call), on
every projection case of ``heatmap_tpu_torch.kernel_cases``, on strided
and broadcast inputs, and on a step of the ``geolife-z16`` benchmark
cell's points.

Each test carries the ``card`` marker and skips inside the test where
``torch.cuda.is_available()`` is false. The file imports nothing of JAX,
and runs on a card machine without the suite's JAX conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_project_card.py
"""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from heatmap_tpu_torch import kernel_cases as kc
from heatmap_tpu_torch.tilemath import mercator as tmerc

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on a card machine")
    return torch.device("cuda", 0)


def _held_to_plain(lat, lon, zoom):
    """Project with the kernel and with the plain version; assert that
    they agree and return the lanes rechecked and the kernel's launches."""
    before = tmerc.project_points.rechecked
    want = tmerc._project_plain(lat, lon, zoom)
    k = tmerc.project_points.rechecked - before
    launches = tmerc.project_points.fused_launches
    before = tmerc.project_points.rechecked
    got = tmerc.project_points(lat, lon, zoom)
    torch.cuda.synchronize()
    assert tmerc.project_points.rechecked - before == k
    for g, w in zip(got, want):
        assert g.device == w.device and g.dtype == w.dtype
        assert g.shape == w.shape
        assert torch.equal(g, w)
    return k, tmerc.project_points.fused_launches - launches


@pytest.mark.card
@pytest.mark.parametrize("case", kc.PROJECTION_CASES)
def test_kernel_matches_plain_on_the_card(card, case):
    lat, lon, zoom = kc.projection_case(case)
    k, launches = _held_to_plain(torch.as_tensor(lat, device=card),
                                 torch.as_tensor(lon, device=card), zoom)
    # No launch for no lanes; a second one where the list overflowed.
    assert launches == (lat.size > 0) * (1 + (k > tmerc.FLAGGED_CAPACITY))
    if case == "row_edges_z21":
        assert k == lat.shape[0] > tmerc.FLAGGED_CAPACITY


@pytest.mark.card
def test_kernel_on_strided_and_broadcast_inputs(card):
    lat, lon, zoom = kc.projection_case("mercator_edge")
    pts = torch.stack([torch.as_tensor(lat), torch.as_tensor(lon)],
                      dim=1).to(card)
    _held_to_plain(pts[:, 0], pts[:, 1], zoom)
    _held_to_plain(pts[:, 0].reshape(-1, 8), torch.tensor(179.5, device=card,
                                                          dtype=torch.float64),
                   zoom)
    _held_to_plain(pts[:, 0].reshape(8, -1).T, pts[:, 1].reshape(8, -1).T,
                   zoom)


@pytest.mark.card
def test_kernel_on_the_bulk_cells_points(card):
    """One step of the ``geolife-z16.bulk`` cell: its 24,876,978 points
    from a seed, at z16 and at the batch job's z21."""
    from benchmark import generate

    config = json.loads((ROOT / "benchmark" / "configs" /
                         "geolife-z16.json").read_text())
    lat, lon = generate.mixture_points(config["points_per_step"],
                                       config["points"], 2**31 + 99,
                                       "step-input-0", card)
    for zoom in (config["window"]["zoom"], 21):
        _held_to_plain(lat, lon, zoom)
