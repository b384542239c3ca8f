"""plan_misses: plans the engine had to make inside the window (0 when
the warm-up covered every shape of the cell)."""


def read(run):
    if not run.queue[1].get("plan_cache"):
        return None
    return float(run.plan_delta("misses"))
