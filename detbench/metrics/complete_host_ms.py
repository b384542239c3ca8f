"""complete_host_ms: the completer's host time per dispatched batch, ms:
from the batch's event to its futures resolved (the copy back, the
unpack and the delivery; ``complete_host_s``), over ``dispatches``.
None where the queue does not count ``complete_host_s``."""


def read(run):
    dispatches = run.delta("dispatches")
    if "complete_host_s" not in run.queue[1] or dispatches <= 0:
        return None
    return 1e3 * run.delta("complete_host_s") / dispatches
