"""Seconds from the process's start to the window's start: imports, the
kernels' builds on a first run, the weights, the check steps that warm up
the cell's one shape (the slowest rank's)."""


def read(run):
    return run["setup_s"]
