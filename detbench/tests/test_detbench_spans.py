"""The readers of the queue's own timings of its pipeline
(``stage_busy_ms``, ``stage_cpu_share``, ``complete_host_ms``,
``backlog_ms``): a number in the tiny CPU rehearsal's traced run, and
nothing from a queue that does not count what they read."""

import math
import types

import pytest

from detbench import harness
from test_detbench_run import rehearse, tiny  # noqa: F401 — the fixture

SPANS = ["stage_busy_ms", "stage_cpu_share", "complete_host_ms",
         "backlog_ms"]
# a snapshot of a queue that times its stager by ``stage_s`` alone
PARENT = {"submitted": 96, "completed": 96, "batches": 30, "dispatches": 30,
          "grad_dispatches": 8, "stage_s": 0.25, "complete_s": 0.01}


def _run(before: dict, after: dict):
    return types.SimpleNamespace(
        queue=(before, after),
        delta=lambda k: after.get(k, 0) - before.get(k, 0))


@pytest.mark.parametrize("cell", ["tiny.values", "tiny.mixed"])
def test_the_traced_run_reads_every_span(tiny, cell):  # noqa: F811
    got = rehearse(tiny, cell, trace=True)["metrics"]
    for name in SPANS:
        assert math.isfinite(got[name]["value"]), name
    assert 0 < got["stage_busy_ms"]["value"] <= got["stage_ms"]["value"]
    assert 0 < got["stage_cpu_share"]["value"]
    assert got["complete_host_ms"]["value"] > 0
    assert got["backlog_ms"]["value"] >= 0
    assert [got[n]["unit"] for n in SPANS] == ["ms", "%", "ms", "ms"]


@pytest.mark.parametrize("name", SPANS)
def test_a_queue_without_the_counters_reads_none(name):
    read = harness.metric_reader(name)
    zero = {k: 0 for k in PARENT}
    assert read(_run(zero, PARENT)) is None
    counted = dict(PARENT, stage_wait_s=0.05, stage_cpu_s=0.1,
                   complete_host_s=0.02, backlog_s=3.0)
    assert read(_run({**zero, **{k: 0 for k in counted}}, counted)) > 0
    # nothing happened in the window: no denominator
    assert read(_run(counted, counted)) is None
