"""The benchmark of ``reveal_tpu_torch``: ``python3 benchmark/run.py``."""
