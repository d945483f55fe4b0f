"""Carry the cascade's state between the JAX package and the port.

The system has no trained parameters: its state is the job's inputs
(made from a seed) and the per-level cascade aggregates. Both packages
hold a level as ``(keys int64[capacity], sums[capacity], n_unique)``;
these helpers move that state through numpy, so the same intermediate
state can feed either package's decode and egress.
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
