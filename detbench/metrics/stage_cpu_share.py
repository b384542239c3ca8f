"""stage_cpu_share: the share of the stager's busy time (``stage_s`` less
``stage_wait_s``) that its thread ran on a CPU (``stage_cpu_s``, by
``time.thread_time``), %.  The rest went to waiting on the interpreter
lock, a collection or a blocking call.  None where the queue does not
count ``stage_cpu_s``."""


def read(run):
    if not {"stage_wait_s", "stage_cpu_s"} <= set(run.queue[1]):
        return None
    busy = run.delta("stage_s") - run.delta("stage_wait_s")
    if busy <= 0:
        return None
    return 100.0 * run.delta("stage_cpu_s") / busy
