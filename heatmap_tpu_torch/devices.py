"""Device selection for the port's entry points and per-stage timing."""

from __future__ import annotations

import contextlib
import time

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device a job runs on.

    The default is the card. The CPU runs only when the caller names
    it; asking for CUDA where there is none raises instead of falling
    back, so a job never leaves the device silently.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions "
            "on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


class StageTimer:
    """Wall-clock milliseconds per named stage of a job.

    The device is synchronised on entry to and exit from every stage,
    so each stage's time covers its own device work and nothing
    queued before it. Each entry appends one time to ``ms[name]``.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms: dict[str, list[float]] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.ms.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)


def stage(timer: StageTimer | None, name: str):
    """``timer.stage(name)``, or a no-op context when ``timer`` is None."""
    return contextlib.nullcontext() if timer is None else timer.stage(name)


@contextlib.contextmanager
def cascade_stage(timer: StageTimer | None, name: str, items=None):
    """One stage of the cascade (``sort``, ``segment_reduce``), named
    once for both of its timings: ``timer``'s fenced stage ``name`` and
    the trace's stage span ``cascade.<name>`` (underscores as hyphens,
    the JAX package's span names). Under stage tracing the span closes
    only after the card has finished the stage's work
    (``utils.trace.stage_block``)."""
    from heatmap_tpu_torch.utils import trace

    with stage(timer, name), trace.stage_span(
            "cascade." + name.replace("_", "-"), items=items):
        yield
        trace.stage_block(None)


def process_count() -> int:
    """Processes in this job: the ``torch.distributed`` group's world
    size once a multihost job has joined its cluster
    (parallel.multihost.initialize), else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the job (0 on a single process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0
