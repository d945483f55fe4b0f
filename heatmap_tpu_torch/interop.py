"""Carry state between the JAX package and the port.

The system has no trained parameters: its state is the job's inputs
(made from a seed), the per-level cascade aggregates and, for window
binning, the window and its rasters. Both packages hold a cascade level
as ``(keys int64[capacity], sums[capacity], n_unique)`` and a window as
the five integers of its ``Window``; these helpers move that state
through numpy and plain integers, so the same intermediate state can
feed either package without the port importing the other.
"""

from __future__ import annotations

import numpy as np
import torch


def levels_from_numpy(level_data, device="cpu"):
    """Per-level ``(keys, sums, n_unique)`` numpy triples (for example a
    JAX cascade's levels after ``np.asarray``) as the port's tensors on
    ``device``; ``n_unique`` becomes an int32 scalar tensor."""
    dev = torch.device(device)
    return [
        (torch.tensor(np.asarray(keys, np.int64), device=dev),
         torch.tensor(np.asarray(sums), device=dev),
         torch.as_tensor(int(np.asarray(n)), dtype=torch.int32, device=dev))
        for keys, sums, n in level_data
    ]


def levels_to_numpy(level_data):
    """The port's per-level tensors as ``(keys, sums, n_unique)`` numpy
    triples (``n_unique`` a Python int)."""
    return [
        (keys.cpu().numpy(), sums.cpu().numpy(), int(n))
        for keys, sums, n in level_data
    ]


def window_from_fields(zoom: int, row0: int, col0: int, height: int,
                       width: int):
    """The port's ``Window`` with these fields (for example those of a
    JAX ``Window``: ``window_from_fields(**dataclasses.asdict(w))``)."""
    from heatmap_tpu_torch.ops.histogram import Window

    return Window(zoom=int(zoom), row0=int(row0), col0=int(col0),
                  height=int(height), width=int(width))


def raster_from_numpy(raster, device="cpu"):
    """A window raster (numpy, or anything ``np.asarray`` takes, such as
    a JAX array) as a tensor on ``device``, dtype kept."""
    return torch.from_numpy(np.array(raster, copy=True)).to(device)


def raster_to_numpy(raster):
    """A window raster tensor as a host numpy array, dtype kept."""
    return raster.detach().cpu().numpy()
