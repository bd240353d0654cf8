"""The benchmark of ``openimpala_tpu_torch``: ``run.py`` runs one cell of
``BENCHMARK.json`` once (see ``harness.py``); ``reference/`` is the plain
reference that decides ``correct``; ``control.py`` reads its control."""
