"""The dense pyramid on the CPU: ``ops/pyramid.py`` ``pyramid_from_raster``,
``coarsen_raster`` and ``bench.pyramid_capped`` against the JAX package
and a NumPy twin, and the host side of the kernel path
(``pyramid._launch``) on a stand-in for ``csrc/dense_pyramid.cu``.

Int32 and integer-valued float32 rasters equal the JAX package's
reshape-sums; non-integer float32 equals ``(a00 + a01) + (a10 + a11)``
of each level below, bit for bit. The kernel itself runs only on the
card (``tests/test_torch_dense_pyramid_card.py``)."""

import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatmap_tpu.ops import pyramid as jpyr
from heatmap_tpu_torch import bench as tbench
from heatmap_tpu_torch import kernel_cases as kc
from heatmap_tpu_torch.ops import pyramid as tpyr

_NP_DTYPES = {0: np.int32, 1: np.float32}


def _numpy_twin(raster: np.ndarray, levels: int) -> list:
    """Levels 1..``levels``, each cell ``(a00 + a01) + (a10 + a11)`` of
    the level below, in the raster's dtype."""
    out, r = [], raster
    for _ in range(levels):
        r = ((r[..., 0::2, 0::2] + r[..., 0::2, 1::2])
             + (r[..., 1::2, 0::2] + r[..., 1::2, 1::2]))
        out.append(r)
    return out


def _raster(case):
    base, index, levels = kc.pyramid_case(case)
    return torch.as_tensor(base)[index], levels


def _assert_levels(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("shape,levels", [((64, 96), 5), ((3, 64, 96), 5),
                                          ((2, 3, 16, 24), 3), ((2, 2), 1)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_pyramid_matches_jax(shape, levels, dtype):
    raster = np.random.default_rng(5).integers(0, 50, shape).astype(dtype)
    want = jpyr.pyramid_from_raster(jnp.asarray(raster), levels)
    got = tpyr.pyramid_from_raster(torch.as_tensor(raster), levels)
    assert len(got) == len(want) == levels + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.as_tensor(raster).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tpyr.coarsen_raster(torch.as_tensor(raster)).numpy(),
        np.asarray(jpyr.coarsen_raster(jnp.asarray(raster))))


@pytest.mark.parametrize("case", ["float32", "unaligned_block", "int32_wrap",
                                  "row_block", "batch", "tile_ragged"])
def test_sums_in_the_written_order(case):
    """Non-integer float32 (the order of adds decides the bits), int32
    sums that wrap, and views of wider rasters, against the NumPy twin."""
    raster, levels = _raster(case)
    got = tpyr.pyramid_from_raster(raster, levels)
    assert got[0] is raster
    _assert_levels(got[1:], _numpy_twin(raster.numpy(), levels))


@pytest.mark.parametrize("shape,levels", [((6, 10), 1), ((2, 2), 1),
                                          ((3, 64, 96), 5), ((6, 10), 2),
                                          ((3, 64, 96), 6), ((4, 5), 1),
                                          ((2, 2), 2)])
def test_levels_stop_where_a_side_turns_odd(shape, levels):
    """A level exists while both sides of the level below are even; past
    that both packages raise the same ValueError, the port before any
    work."""
    raster = np.arange(math.prod(shape), dtype=np.int32).reshape(shape)
    try:
        want = jpyr.pyramid_from_raster(jnp.asarray(raster), levels)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            tpyr.pyramid_from_raster(torch.as_tensor(raster), levels)
        assert str(err.value) == str(e)
        return
    got = tpyr.pyramid_from_raster(torch.as_tensor(raster), levels)
    _assert_levels(got, [np.asarray(w) for w in want])


@pytest.mark.parametrize("shape", [(4, 5), (3, 4), (2, 7, 6), (1, 1)])
def test_coarsen_refusal_text_equals_jax(shape):
    with pytest.raises(ValueError) as jerr:
        jpyr.coarsen_raster(jnp.zeros(shape, jnp.int32))
    with pytest.raises(ValueError) as terr:
        tpyr.coarsen_raster(torch.zeros(shape, dtype=torch.int32))
    assert str(terr.value) == str(jerr.value)


def _capped_loop(raster, levels):
    """bench.pyramid_capped's rule as a loop of single levels: stop where
    a side of the last level is below 2."""
    out = [raster]
    for _ in range(levels):
        if min(out[-1].shape[-2:]) < 2:
            break
        out.append(tpyr.coarsen_raster(out[-1]))
    return out


@pytest.mark.parametrize("shape,levels", [((64, 32), 10), ((2, 2), 5),
                                          ((1, 8), 3), ((4096, 4096), 15),
                                          ((8192, 4096), 10), ((6, 10), 3),
                                          ((24, 40), 0)])
def test_pyramid_capped_stop_rule(shape, levels):
    raster = torch.ones(shape, dtype=torch.int32)
    try:
        want = _capped_loop(raster, levels)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            tbench.pyramid_capped(raster, levels)
        assert str(err.value) == str(e)
        return
    got = tbench.pyramid_capped(raster, levels)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if shape == (8192, 4096):
        assert len(got) == levels + 1
        assert tuple(got[-1].shape) == (8, 4)


@pytest.mark.parametrize("case", ["batch", "float32", "small_ragged"])
def test_levels_are_contiguous_views_of_one_buffer(case):
    raster, levels = _raster(case)
    got = tpyr.pyramid_from_raster(raster, levels)
    _, views = tpyr._layout(tuple(raster.shape), levels)
    storage = got[1].untyped_storage().data_ptr()
    for g, (shape, _, _) in zip(got[1:], views):
        assert tuple(g.shape) == shape and g.is_contiguous()
        assert g.dtype == raster.dtype
        assert g.untyped_storage().data_ptr() == storage
        # Each level starts on a 128-byte boundary of the buffer.
        assert g.storage_offset() % tpyr._LEVEL_ALIGN == 0


class _StandIn:
    """``hm_dense_pyramid`` of ``csrc/dense_pyramid.cu`` on the CPU: it
    reads the raster through the pointer and element strides it is
    handed and writes each level through its own pointer, as contiguous
    (batch, height >> l, width >> l), with the kernel's sums. Each call's
    arguments are kept."""

    def __init__(self):
        self.calls = []

    def hm_dense_pyramid(self, src, dtype, batch, batch_stride, row_stride,
                         height, width, n_levels, levels, stream):
        self.calls.append((dtype, batch, batch_stride, row_stride, height,
                           width, n_levels))
        assert 1 <= n_levels <= tpyr.KERNEL_LEVELS
        assert height % (1 << n_levels) == 0 == width % (1 << n_levels)
        np_dtype = _NP_DTYPES[dtype]
        ctype = np.ctypeslib.as_ctypes_type(np_dtype)
        extent = ((batch - 1) * batch_stride + (height - 1) * row_stride
                  + width)
        flat = np.ctypeslib.as_array((ctype * extent).from_address(src))
        size = flat.itemsize
        raster = np.lib.stride_tricks.as_strided(
            flat, (batch, height, width),
            (batch_stride * size, row_stride * size, size))
        for lvl, cells in enumerate(_numpy_twin(raster, n_levels), 1):
            out = np.ctypeslib.as_array(
                (ctype * cells.size).from_address(levels[lvl - 1]))
            out[:] = cells.reshape(-1)
        return 0


@contextlib.contextmanager
def _on_stand_in(monkeypatch):
    lib = _StandIn()
    monkeypatch.setattr(tpyr._build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    yield lib


@pytest.mark.parametrize("case", kc.PYRAMID_CASES)
def test_kernel_host_side_matches_plain(monkeypatch, case):
    """The wrapper's launches on the stand-in: the levels the plain
    version gives, one counted launch a KERNEL_LEVELS levels, the later
    launches reading the last level written."""
    raster, levels = _raster(case)
    want = tpyr._plain(raster, levels)
    before = tpyr.pyramid_from_raster.launches
    with _on_stand_in(monkeypatch) as lib:
        got = tpyr._launch(raster, levels)
    n_launches = math.ceil(levels / tpyr.KERNEL_LEVELS)
    assert tpyr.pyramid_from_raster.launches - before == n_launches
    assert len(lib.calls) == n_launches
    *_, height, width = raster.shape
    batch = math.prod(raster.shape[:-2])
    first = lib.calls[0]
    assert first[1:] == (batch, raster.stride(0) if raster.dim() == 3 else 0,
                         raster.stride(-2), height, width,
                         min(levels, tpyr.KERNEL_LEVELS))
    for call, done in zip(lib.calls[1:], range(tpyr.KERNEL_LEVELS, levels,
                                               tpyr.KERNEL_LEVELS)):
        h, w = height >> done, width >> done
        assert call[1:] == (batch, h * w, w, h, w,
                            min(levels - done, tpyr.KERNEL_LEVELS))
    for g, w in zip(got, want[1:]):
        assert g.dtype == w.dtype and g.is_contiguous()
        assert torch.equal(g, w)


def test_kernel_host_side_refusals(monkeypatch):
    ints = torch.zeros((4, 8, 8), dtype=torch.int32)
    with _on_stand_in(monkeypatch) as lib:
        with pytest.raises(TypeError, match="int32 and float32"):
            tpyr._launch(ints.double(), 1)
        with pytest.raises(ValueError, match="stride 1"):
            tpyr._launch(ints.transpose(-1, -2), 1)
        folded = torch.zeros((2, 3, 8, 8), dtype=torch.int32).transpose(0, 1)
        with pytest.raises(ValueError, match="fold into one"):
            tpyr._launch(folded, 1)
        # No cells and no levels launch nothing.
        empty = torch.zeros((0, 8, 8), dtype=torch.int32)
        assert [tuple(x.shape) for x in tpyr._launch(empty, 2)] == [
            (0, 4, 4), (0, 2, 2)]
        assert tpyr._launch(ints.double(), 0) == []
        # Leading dimensions of size 1 and a batch sliced from a larger
        # one fold.
        batch = torch.arange(6 * 8 * 8, dtype=torch.int32).reshape(6, 1, 8, 8)
        got = tpyr._launch(batch[1:5], 3)
        for g, w in zip(got, tpyr._plain(batch[1:5], 3)[1:]):
            assert torch.equal(g, w)
    assert [c[1:3] for c in lib.calls] == [(4, 64)]


def test_cpu_rasters_never_launch():
    before = tpyr.pyramid_from_raster.launches
    raster, levels = _raster("batch")
    tpyr.pyramid_from_raster(raster, levels)
    tbench.pyramid_capped(raster[0, :, :512], 20)
    assert tpyr.pyramid_from_raster.launches == before
