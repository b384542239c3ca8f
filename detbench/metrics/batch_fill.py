"""batch_fill: requests answered over the slots of the batches the queue
dispatched in the window (``max_batch`` a batch), %.  The queue's
``dispatches`` counts gradient batches too (``grad_dispatches`` is a
part of it)."""


def read(run):
    batches = run.delta("dispatches")
    if batches <= 0:
        return None
    return 100.0 * run.delta("completed") / (
        batches * int(run.config["max_batch"]))
