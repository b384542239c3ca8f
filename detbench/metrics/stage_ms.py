"""stage_ms: the stager's host time per batch (plan buckets, pad, stack,
upload, launch), from the queue's ``stage_s`` and ``batches``, ms."""


def read(run):
    batches = run.delta("batches")
    if batches <= 0:
        return None
    return 1e3 * run.delta("stage_s") / batches
