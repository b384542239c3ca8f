"""backlog_ms: the mean wait of a delivered request from its submit to
the stager's snapshot that took it (``backlog_s`` over ``completed``),
ms.  None where the queue does not count ``backlog_s``."""


def read(run):
    completed = run.delta("completed")
    if "backlog_s" not in run.queue[1] or completed <= 0:
        return None
    return 1e3 * run.delta("backlog_s") / completed
