"""PyTorch/CUDA port of heatmap_tpu's batch job and window binning.

The package runs the reference ``batchMain`` (source -> f64 projection
-> emissions -> composite-key cascade -> decode -> blobs), single-shot,
chunked with a cross-chunk merge, on the integer fast path of CSV and
HMPB files, or with checkpoint/resume, and dense
window binning (the ``tiles`` command and the headline benchmark,
``heatmap_tpu_torch.bench``) with PyTorch on an NVIDIA Hopper card. The
cascade's per-level segment reduce and the two window-binning backends
are hand-written CUDA kernels (``csrc/*.cu``), built with ``nvcc`` at
first use (``_build.py``); host decode and JSON egress use the repo's
C++ runtime (``native/``, bound in ``native.py``), built with ``make``
at first use.

It imports torch and numpy only: nothing of JAX and nothing of
``heatmap_tpu``. Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, where every kernel's plain PyTorch
version runs instead.
"""

from heatmap_tpu_torch.devices import resolve_device
from heatmap_tpu_torch.pipeline.batch import (
    BatchJobConfig,
    run_batch,
    run_job,
    run_job_fast,
    run_job_resumable,
)

__version__ = "0.1.0"

__all__ = ["BatchJobConfig", "resolve_device", "run_batch", "run_job",
           "run_job_fast", "run_job_resumable"]
