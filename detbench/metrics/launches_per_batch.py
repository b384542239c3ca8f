"""launches_per_batch: kernel launches the wrappers counted in the window
(``_launch.launch_counts``) per batch the queue dispatched.  Nothing to
read where no wrapper launched (the plain CPU path)."""


def read(run):
    launches = sum(run.launch_delta().values())
    batches = run.delta("dispatches")
    if launches <= 0 or batches <= 0:
        return None
    return launches / batches
