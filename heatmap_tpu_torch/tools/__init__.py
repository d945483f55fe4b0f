"""Bench tools of the port: twins of the JAX package's ``tools/``
scripts that measure the main paths, run as
``python -m heatmap_tpu_torch.tools.<name>``.

- ``bench_job``: the batch job end to end (HMPB ingest, cascade,
  egress), one subprocess per measurement (``tools/bench_job.py``);
- ``bench_delta``: a full recompute against an incremental delta apply
  (``tools/bench_delta.py``);
- ``bench_ingest``: continuous ingest, exact against bucketed padding,
  throughput and lag (``tools/bench_ingest.py``).

Each prints the JAX tool's record keys, plus ``device`` and, on a card,
``gpu_name`` and ``power_limit_w``, and writes its record under
``build/torch_bench/`` unless ``--out`` names another file. They run on
the card unless ``--device cpu`` is given.
"""
