"""idle_share: the share of the traced window in which nothing ran on the
card: 1 - busy / window, busy being the union of the recorded kernel and
copy intervals plus the time of lost records, %."""


def read(run):
    t = run.traced
    if t is None or not t["device_events"] or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / run.window_s)
