"""Twin of ``tests/test_runtime.py`` for the port's runtime package
(``repro_torch.runtime``): the same regression battery, run on the port,
plus the elastic grid rule held to the reference's, and the runtime
legs of ``tests/test_substrates.py``.

The reference's battery pins three fixes:

* ``Watchdog`` read/wrote its deadline and latch without a lock — a
  beater thread racing the monitor could see a stale deadline and fire
  spuriously, and ``fired`` latched forever with no way to clear it.
* ``StepTimer`` counted the EMA *seed* sample toward warmup, shifting
  the detection gate by one step and skewing the ids in ``stragglers``.
* ``run_grains`` mutated the shared ``fail_on`` set outside the
  scheduler lock (two speculative attempts could both consume one
  failure token) and hardcoded the attempt cap, with a terminal error
  that named nothing.
"""

import threading
import time

import pytest

from repro_torch.runtime import (StepTimer, Watchdog, choose_mesh,
                                 run_grains)


# ------------------------------------------------------------------ watchdog
def test_watchdog_quiet_under_concurrent_beating():
    """Four threads beating every 10 ms for 3× the timeout: the monitor
    must never observe a stale deadline and fire (pre-fix, the unlocked
    check-then-act raced the beaters)."""
    fired = []
    wd = Watchdog(0.5, lambda: fired.append(time.monotonic())).start()
    stop = threading.Event()

    def beater():
        while not stop.is_set():
            wd.beat()
            time.sleep(0.01)

    threads = [threading.Thread(target=beater) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join()
    wd.stop()
    assert fired == []
    assert wd.fired is False


def test_watchdog_reset_clears_latch_and_rearms():
    fired = []
    wd = Watchdog(0.1, lambda: fired.append(1)).start()
    time.sleep(0.3)
    assert wd.fired is True and fired
    wd.reset()
    wd.beat()
    wd.stop()
    assert wd.fired is False  # one stall must not poison later probes


def test_watchdog_on_stall_may_reset_without_deadlock():
    """The stall handler runs outside the lock, so it may beat()/reset()
    the watchdog itself; a handler that deadlocked would wedge the
    monitor thread after the first fire."""
    fires = []
    holder = {}

    def handler():
        fires.append(time.monotonic())
        holder["wd"].reset()

    holder["wd"] = Watchdog(0.1, handler).start()
    deadline = time.monotonic() + 5.0
    while len(fires) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    holder["wd"].stop()
    assert len(fires) >= 2  # kept firing => handler's reset() didn't wedge


# ----------------------------------------------------------------- steptimer
def test_step_timer_seed_is_calibration_not_warmup():
    t = StepTimer(warmup=2)
    assert t.record(1, 1.0) is False  # seeds the EMA ...
    assert t.n == 0                   # ... but is not a measured sample


def test_step_timer_warmup_gate_exact_steps():
    """Known dt sequence that distinguishes the fixed gate from the
    off-by-one: with ``warmup=2`` the seed plus two measured samples
    pass unflagged, so step 3's outlier (the 2nd measured sample) is
    still warmup — under the old seed-counted gate it was flagged.
    Step 3's dt then *feeds the EMA*, which the old gate never allowed.
    """
    t = StepTimer(warmup=2)  # alpha=0.1, factor=2.0
    dts = {1: 1.0, 2: 1.0, 3: 5.0, 4: 1.0, 5: 5.0}
    flags = [t.record(step, dts[step]) for step in sorted(dts)]
    # step 3: n=2, gate 2 > 2 is False -> absorbed: ema = .9*1 + .1*5 = 1.4
    # step 5: n=4, armed; 5.0 > 2*1.36 -> flagged (old gate: [3, 5])
    assert flags == [False, False, False, False, True]
    assert t.stragglers == [5]
    assert t.ema == pytest.approx(0.9 * 1.4 + 0.1 * 1.0)  # outlier excluded


# ---------------------------------------------------------------- run_grains
def test_run_grains_max_attempts_caps_reissue():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise RuntimeError("boom")
        return 7.0

    with pytest.raises(RuntimeError, match=r"max_attempts=3"):
        run_grains([flaky], 1, max_attempts=3)
    calls["n"] = 0
    assert run_grains([flaky], 1, max_attempts=4) == [7.0]


def test_run_grains_terminal_error_names_grains_and_attempts():
    def bad():
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError) as ei:
        run_grains([bad, lambda: 1.0, bad], 2, max_attempts=2)
    msg = str(ei.value)
    assert "grain 0 after 2 attempt(s)" in msg
    assert "grain 2 after 2 attempt(s)" in msg
    assert "grain 1" not in msg  # the grain that finished is not blamed


def test_run_grains_validates_max_attempts():
    with pytest.raises(ValueError):
        run_grains([lambda: 1.0], 1, max_attempts=0)


def test_run_grains_fail_on_tokens_consumed_exactly_once():
    """The injected-failure check mutates the shared ``fail_on`` set, so
    it must happen under the scheduler lock: with both workers holding a
    token for the same grain, each token kills exactly one attempt and
    the grain still completes within the cap."""
    # deterministic single-worker leg: the one token dies with attempt 1
    # and is gone for attempt 2 — a double-spend would fail both attempts
    fail_on = {(0, 5)}
    fns = [lambda g=g: float(g) for g in range(8)]
    assert run_grains(fns, 1, max_attempts=2, fail_on=fail_on) == \
        [float(g) for g in range(8)]
    assert fail_on == set()

    # concurrent leg: both workers hold a token for grain 5; whichever
    # attempts it consumes only its own token, and the grain still
    # completes within the cap
    fail_on = {(0, 5), (1, 5)}
    out = run_grains(fns, 2, max_attempts=3, fail_on=fail_on)
    assert out == [float(g) for g in range(8)]
    assert len(fail_on) <= 1  # one worker may simply never draw grain 5


# ------------------------------------------------------------ elastic rule
def test_choose_mesh_equals_reference():
    """The framework-free grid rule the autoscaler's worker ceiling
    uses: the same plan as the reference's for every device count,
    model cap and pod request."""
    ref = pytest.importorskip("repro.runtime.elastic")
    for n in range(0, 70):
        for max_model in (1, 2, 4, 16):
            for pods in (1, 2, 3):
                got = choose_mesh(n, max_model=max_model, want_pods=pods)
                want = ref.choose_mesh(n, max_model=max_model,
                                       want_pods=pods)
                assert (got.shape, got.axis_names, got.n_devices) == \
                    (want.shape, want.axis_names, want.n_devices)


# ------------------------------------- the legs of test_substrates.py
def test_choose_mesh_shrinks_on_failures():
    full = choose_mesh(512, max_model=16, want_pods=2)
    assert full.shape == (2, 16, 16)
    # lose a pod
    half = choose_mesh(256, max_model=16)
    assert half.shape == (16, 16)
    # lose arbitrary nodes: 509 -> largest pow2 = 256
    broken = choose_mesh(509, max_model=16)
    assert broken.n_devices == 256
    tiny = choose_mesh(1)
    assert tiny.shape == (1, 1)


def test_watchdog_fires_on_stall():
    fired = []
    wd = Watchdog(timeout_s=0.1, on_stall=lambda: fired.append(1)).start()
    time.sleep(0.3)
    wd.stop()
    assert fired


def test_watchdog_quiet_when_beating():
    wd = Watchdog(timeout_s=0.3, on_stall=lambda: None).start()
    for _ in range(5):
        wd.beat()
        time.sleep(0.05)
    wd.stop()
    assert not wd.fired


def test_step_timer_flags_outliers():
    t = StepTimer(warmup=2)
    for i in range(10):
        assert not t.record(i, 1.0)
    assert t.record(10, 5.0)
    assert t.stragglers == [10]


def test_run_grains_survives_failures_and_speculation():
    vals = [float(i) for i in range(8)]
    fns = [lambda v=v: v for v in vals]
    # worker 0 dies on grains 1 and 3; speculation must recover
    out = run_grains(fns, n_workers=3, fail_on={(0, 1), (0, 3), (1, 5)})
    assert out == vals


def test_run_grains_no_duplicates():
    calls = []
    lock = threading.Lock()

    def mk(i):
        def f():
            with lock:
                calls.append(i)
            return i
        return f
    out = run_grains([mk(i) for i in range(16)], n_workers=4)
    assert out == list(range(16))
