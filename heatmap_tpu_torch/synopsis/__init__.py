"""Wavelet-synopsis coarse levels: bounded-error compressed pyramids.

The port's copy of the numpy half of heatmap_tpu/synopsis: each coarse
level's per-cell count grid kept as its B largest Haar coefficients,
with the achieved L-inf error stamped into the artifact (arxiv
1110.6649; docs/synopsis.md). Compaction of a delta store writes these
artifacts beside the merged base.

- transform.py  the 2D and 1D Haar transforms and their inverses
                (numpy), and the torch twins of the 2D forward.
- build.py      top-B selection, error stamping, synopsis-z*.npz
                artifact read/write/verify.
- metrics.py    obs registry handles.
"""

from heatmap_tpu_torch.synopsis.build import (  # noqa: F401
    DEFAULT_MAX_Z, HARD_MAX_Z, SCHEMA, SynopsisPair, build_pair,
    decode_pair, default_b, load_synopses, synopsis_path, verify_synopsis,
    write_synopses,
)
from heatmap_tpu_torch.synopsis.transform import (  # noqa: F401
    grid_from_rows_np, grid_from_rows_torch, haar2d_np, haar2d_torch,
    inv_haar2d_np,
)
