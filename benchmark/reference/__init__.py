"""The plain reference that decides a run's ``correct``: REVEAL's serial
LIFO ``rem`` in NumPy (``engine.rem_gfa``), importing nothing of the
program."""
