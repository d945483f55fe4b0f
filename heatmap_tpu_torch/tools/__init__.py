"""Bench tools of the port: twins of the JAX package's ``tools/``
scripts that measure the main paths, run as
``python -m heatmap_tpu_torch.tools.<name>``.

- ``bench_job``: the batch job end to end (HMPB ingest, cascade,
  egress), one subprocess per measurement (``tools/bench_job.py``);
- ``bench_delta``: a full recompute against an incremental delta apply
  (``tools/bench_delta.py``);
- ``bench_ingest``: continuous ingest, exact against bucketed padding,
  throughput and lag (``tools/bench_ingest.py``);
- ``bench_writeplane``: the write plane at 1, 2 and 4 writers,
  byte-gated against one delta store (``tools/bench_writeplane.py``);
- ``bench_temporal``: folds per temporal cut, temporal tiles, a
  predicate retraction and ``topk_growth`` (``tools/bench_temporal.py``);
- ``bench_query``: ``/query`` on integral and fall-through stores and
  through a thread-mode fleet (``tools/bench_query.py``);
- ``bench_synopsis``: synopsis bytes, decode latency, the re-verified
  error stamp and early-serve lag (``tools/bench_synopsis.py``);
- ``mem_probe``: peak memory of the bounded merge per mode in fresh
  processes (on a card, their peak device bytes too), or of a serve
  fleet (``tools/mem_probe.py``);
- ``tilefs_convert``: a store to zero-copy tilefs mirrors
  (``tools/tilefs_convert.py``);
- ``soak``: cross-path equivalences at scale (``tools/soak.py``);
- ``load_gen``: closed-loop serving load, fleets, brownout, cold
  against warm restarts (``tools/load_gen.py``).
- ``chaos_soak``: the whole pipeline under the seeded fault plane,
  byte-identical to a clean run, never a 500 (``tools/chaos_soak.py``);
- ``multiproc_check``: k real processes over gloo, every multihost
  egress against one process (``tools/multiproc_check.py``);
- ``_epoch``: the kernel epoch, a hash of the kernel sources and their
  plain versions; standard library only, loaded by path
  (``tools/_epoch.py``);
- ``verify_partitioned_onchip``: the kernels bit-exact on the card
  across their plans, keyed by the epoch
  (``tools/verify_partitioned_onchip.py``);
- ``sweep_partitioned``: the same plans timed beside the PyTorch calls
  they compete with (``tools/sweep_partitioned.py``);
- ``apply_decisions``: the measurement-gated decisions over those
  records (``tools/apply_decisions.py``).

Each prints the JAX tool's record keys, plus ``device`` and, on a card,
``gpu_name`` and ``power_limit_w``, and writes its record under
``build/torch_bench/`` unless ``--out`` names another file
(``tilefs_convert``: ``--record``; the last six print their lines, and
the card tools keep their state under ``build/torch_onchip_state/``).
They run on the card unless ``--device cpu`` is given; the verify and
sweep twins refuse the CPU (exit code 2), and ``_epoch`` and
``apply_decisions`` do no device work.
"""
