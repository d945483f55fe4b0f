"""The benchmark of ``heatmap_tpu_torch`` on one or four NVIDIA H100 cards.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``
(whose ``driver`` names a module of ``drivers/``), and each metric's
reader in ``metrics/<metric>.py``. ``reference/`` is the plain NumPy
reference that decides ``correct``; it imports nothing of the program.
"""
