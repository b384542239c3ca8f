"""req_per_s: requests answered without error over the whole window,
drain included (host clock)."""


def read(run):
    if run.window_s <= 0:
        return None
    return (run.answered - run.failed) / run.window_s
