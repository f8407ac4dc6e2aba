"""The benchmark of the PyTorch/CUDA port ``gpvecchia_torch``: one cell a
run (``run.py``), configurations, traffic mixes, layers and per-layer
metrics as files found by their names, and a plain reference
(``reference/``) that decides whether a run's answers are correct."""
