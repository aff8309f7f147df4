"""setup_s (s, lower is better; host clock): from the process's start to
the start of the first timed job: imports, the CUDA context, loading (or,
in a checkout's first run, building) the program's native library and
CUDA kernels, the fastas, and one untimed job on the cell's input."""


def read(run):
    return run.setup_s
