"""stage_busy_ms: the stager's own time per batch, ms: its time a
snapshot (``stage_s``) less the part it spent blocked on the full
in-flight queue (``stage_wait_s``), over ``batches``.  None where the
queue does not count ``stage_wait_s``."""


def read(run):
    batches = run.delta("batches")
    if "stage_wait_s" not in run.queue[1] or batches <= 0:
        return None
    return 1e3 * (run.delta("stage_s") - run.delta("stage_wait_s")) / batches
