"""Seconds from the process's start to the window's: imports, the kernel
library, the cell's data and the warm-up job."""


def read(run, spec):
    return run.setup_s
