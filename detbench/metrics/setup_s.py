"""setup_s: process start → the window's first submit, s: imports, the
card's context, the kernel library's load (or build), the queue and one
batch of every shape of the cell (host clock)."""


def read(run):
    return run.setup_s
