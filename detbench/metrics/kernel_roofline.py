"""kernel_roofline: the least time one H100 needs for the window's
answered work, counted from each request's own (m, n) (``work.py``),
over the device time of the port's kernels in the trace, corrected for
lost records, %.  Nothing to read without a trace that holds them."""

import numpy as np

from detbench import work


def read(run):
    t = run.traced
    if t is None or not t["kernel_s"] or None in t["kernel_s"].values():
        return None
    kernel_s = sum(t["kernel_s"].values())
    if kernel_s <= 0:
        return None
    ops = nbytes = 0
    shapes, counts = np.unique(
        np.column_stack([run.shapes, run.grads.astype(np.int64)]),
        axis=0, return_counts=True)
    for (m, n, g), c in zip(shapes.tolist(), counts.tolist()):
        o, b = work.answer_work(m, n, bool(g))
        ops += c * o
        nbytes += c * b
    least, _ = work.least_seconds(ops, nbytes)
    return 100.0 * least / kernel_s
