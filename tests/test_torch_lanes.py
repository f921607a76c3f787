"""The executor's N-lane ``LaneSpec`` table on the CPU, held to the JAX package's.

- ``LaneSpec`` and ``default_lanes`` equal field for field;
- the JAX package's lane cases (``tests/parallel/test_fair_share.py``
  ``TestLanes``) as cases of one test, each run through both executors with
  the same queued slots on the same clock: the same ``_take_due`` batches,
  reasons and order, the same ``queue_depth()`` and ``_next_deadline()``;
- the JAX package's threaded speculative-lane cases
  (``tests/parallel/test_batch_executor.py`` ``TestSpeculativeLane``) on the
  port's executor with stub programs.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.parallel import batch_executor as jexecutor
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.compute import ir
from vizier_tpu_torch.parallel import batch_executor as texecutor


def test_lane_spec_and_default_lanes_equal_the_jax_packages():
    assert ([(f.name, f.default) for f in dataclasses.fields(texecutor.LaneSpec)]
            == [(f.name, f.default) for f in dataclasses.fields(jexecutor.LaneSpec)])
    assert (texecutor.LANE_LIVE, texecutor.LANE_SPECULATIVE) == (
        jexecutor.LANE_LIVE, jexecutor.LANE_SPECULATIVE)
    for cap in (250.0, 0.0, 30.0):
        assert ([dataclasses.astuple(lane) for lane in texecutor.default_lanes(cap)]
                == [dataclasses.astuple(lane) for lane in jexecutor.default_lanes(cap)])
    with pytest.raises(dataclasses.FrozenInstanceError):
        texecutor.LaneSpec("live", 0).priority = 1


# -- TestLanes, through both executors --------------------------------------------

_THREE_LANES = (("live", 0, False, 0.0), ("batchwork", 1, True, 100.0),
                ("speculative", 2, True, 250.0))


class _Run:
    """One executor of ``mod`` on a clock, its queues filled by hand, and the
    trace of what it answers."""

    def __init__(self, mod, lanes=None, **kwargs):
        self.mod, self.clock, self.trace, self._next = mod, [0.0], [], 0
        table = None if lanes is None else [mod.LaneSpec(*lane) for lane in lanes]
        self.ex = mod.BatchExecutor(time_fn=lambda: self.clock[0], lanes=table, **kwargs)

    def slots(self, n=1, lane=None, at=0.0):
        kind = {} if lane is None else {"lane": lane}
        out = [self.mod._Slot(self._next + i, None, 1, at, None, **kind) for i in range(n)]
        self._next += n
        return out

    def queue(self, key, slots):
        self.ex._queues[key] = slots

    def step(self, t):
        self.clock[0] = t
        with self.ex._cond:
            depth = self.ex.queue_depth()
            due = self.ex._take_due()
            deadline = self.ex._next_deadline()
        self.trace.append((t, depth, [(key, [s.designer for s in slots], reason)
                                      for key, slots, reason in due], deadline))
        return [(key, reason) for key, _, reason in due]

    def close(self):
        self.ex.close()
        return self.trace


def _default_table(run):
    """test_default_lane_table_matches_two_lane_contract."""
    by_name = run.ex._lanes
    run.trace.append(sorted(dataclasses.astuple(lane) for lane in by_name.values()))
    assert by_name["live"].priority < by_name["speculative"].priority
    assert not by_name["live"].deferrable and by_name["speculative"].deferrable
    assert by_name["speculative"].starvation_cap_ms == 250.0


def _slot_lane_back_compat(run):
    """test_slot_lane_back_compat, and ``suggest``'s mapping onto a lane."""
    live, spec = run.slots()[0], run.slots(lane="speculative")[0]
    run.trace.append((live.lane, live.speculative, spec.lane, spec.speculative))
    assert not live.speculative and spec.speculative


def _deferrable_lane_waits_for_idle_window(run):
    """test_deferrable_lane_waits_for_idle_window."""
    run.queue("spec", run.slots(lane="speculative", at=0.0))
    run.queue("live", run.slots(at=0.0))
    assert run.step(0.01) == [("live", "timeout")]  # the spec bucket deferred
    # Fresh live traffic keeps the spec bucket deferring until its cap ...
    run.queue("live", run.slots(at=0.299))
    assert run.step(0.3) == [("spec", "spec_starved")]
    # ... while with no priority traffic queued the idle window opens.
    run.queue("spec", run.slots(lane="speculative", at=0.3))
    run.ex._queues.pop("live", None)
    assert run.step(0.31) == [("spec", "timeout")]


def _third_lane_orders_after_live(run):
    """test_third_lane_slots_order_after_live."""
    run.queue("spec", run.slots(lane="speculative", at=0.0))
    run.queue("mid", run.slots(lane="batchwork", at=0.0))
    run.queue("live", run.slots(at=0.0))
    # Everything is past every cap: the deferred buckets flush starved.
    assert run.step(0.5) == [("live", "timeout"), ("mid", "spec_starved"),
                             ("spec", "spec_starved")]


def _queue_depth_reports_all_lanes(run):
    """test_queue_depth_reports_all_lanes, an unknown lane counted as live."""
    run.queue("a", run.slots() + run.slots(lane="bulk") + run.slots(lane="nowhere"))
    run.step(0.0)
    assert run.ex.queue_depth() == {"live": 2, "bulk": 1}
    assert run.ex.live_pending() == 2


def _three_lanes_defer_by_priority(run):
    """Each deferrable lane defers to every lower priority number queued,
    up to its own cap; an over-full starved bucket flushes in chunks; a
    higher-number slot in a lower-number bucket rides its flush."""
    run.queue("live", run.slots(at=0.0))
    run.queue("mid", run.slots(lane="batchwork", at=0.0))
    run.queue("spec", run.slots(6, lane="speculative", at=0.0))
    assert run.step(0.002) == []
    assert run.step(0.005) == [("live", "timeout")]
    assert run.step(0.006) == [("mid", "timeout")]
    assert run.step(0.007) == [("spec", "full"), ("spec", "timeout")]
    # Live traffic all along: batchwork waits for its 100 ms cap, the
    # speculative lane for its 250 ms one.
    run.queue("mid", run.slots(lane="batchwork", at=0.05))
    run.queue("spec", run.slots(6, lane="speculative", at=0.05))
    want = ([("live0", "timeout")], [("live1", "timeout")],
            [("live2", "timeout"), ("mid", "spec_starved")],
            [("live3", "timeout"), ("spec", "full"), ("spec", "spec_starved")])
    for i, t in enumerate((0.05, 0.1, 0.16, 0.31)):
        run.queue(f"live{i}", run.slots(at=t))
        assert run.step(t + 0.0045) == want[i]
    run.queue("mixed", run.slots(lane="speculative", at=1.0) + run.slots(lane="batchwork", at=1.0))
    run.queue("live", run.slots(at=1.0))
    assert run.step(1.005) == [("live", "timeout")]
    assert run.step(1.01) == [("mixed", "timeout")]


def _drains_at_priority_zero(run):
    run.queue("spec", run.slots(2, lane="speculative", at=0.0))
    run.queue("mid", run.slots(lane="batchwork", at=0.0))
    run.queue("live", run.slots(at=0.0))
    run.ex._closed = True
    assert [reason for _, reason in run.step(0.0)] == ["drain"] * 3


_CASES = {
    "default_table": (_default_table, None, {}),
    "slot_lane_back_compat": (_slot_lane_back_compat, None, {}),
    "deferrable_lane_waits_for_idle_window": (
        _deferrable_lane_waits_for_idle_window, None,
        dict(max_batch_size=4, max_wait_ms=4.0, speculative_max_wait_ms=250.0)),
    "third_lane_orders_after_live": (
        _third_lane_orders_after_live, _THREE_LANES, dict(max_batch_size=4, max_wait_ms=4.0)),
    "queue_depth_reports_all_lanes": (
        _queue_depth_reports_all_lanes, (("live", 0), ("bulk", 1, True)),
        dict(max_batch_size=4)),
    "three_lanes_defer_by_priority": (
        _three_lanes_defer_by_priority, _THREE_LANES, dict(max_batch_size=4, max_wait_ms=4.0)),
    "drains_at_priority_zero": (_drains_at_priority_zero, _THREE_LANES, {}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_lanes_equal_the_jax_executors(case):
    scenario, lanes, kwargs = _CASES[case]
    traces = []
    for mod in (texecutor, jexecutor):
        run = _Run(mod, lanes, **kwargs)
        try:
            scenario(run)
        finally:
            traces.append(run.close())
    assert traces[0] == traces[1]


# -- TestSpeculativeLane, threaded, with stub programs ---------------------------------


class _StubProgram(ir.DesignerProgram):
    kind = "stub"

    def bucket_key(self, designer, count):
        return ir.BucketKey("stub", 8, 1, 0, 1, count, statics=(designer.group,))

    def prepare(self, designer, count):
        return dict(designer=designer, count=count, value=designer.value)

    def device_program(self, items, pad_to=None):
        return [dict(value=item["value"]) for item in items]

    def finalize(self, designer, item, output):
        designer.batched = True
        return [vz.TrialSuggestion(parameters={"x": output["value"]})] * item["count"]


_PROGRAM = _StubProgram()


class _Stub:
    def __init__(self, value, group="g"):
        self.value, self.group, self.batched = value, group, False

    def compute_program(self, count):
        return _PROGRAM, _PROGRAM.bucket_key(self, count)

    def suggest(self, count=1):
        return [vz.TrialSuggestion(parameters={"x": self.value})] * (count or 1)


def _wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not predicate() and time.monotonic() < deadline:
        time.sleep(0.001)
    assert predicate()


def _start(target, *args):
    thread = threading.Thread(target=target, args=args)
    thread.start()
    return thread


def test_queue_depth_reports_lanes():
    executor = texecutor.BatchExecutor(max_batch_size=8, max_wait_ms=10_000)
    threads = []
    try:
        run = lambda designer, spec: executor.suggest(designer, 1, speculative=spec)  # noqa: E731
        threads = [_start(run, _Stub(2.0, group="spec"), True),
                   _start(run, _Stub(1.0, group="live"), False)]
        _wait_for(lambda: executor.queue_depth() == {"live": 1, "speculative": 1})
        assert executor.live_pending() == 1
    finally:
        executor.close()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)


def test_live_singleton_never_waits_behind_speculative_flush():
    """A queued speculative-only bucket does not become due while a live slot
    is queued: on a fake clock everything is queued at t=0, then the clock
    passes every window at once, and the live singleton flushes first."""
    clock = [0.0]
    executor = texecutor.BatchExecutor(max_batch_size=8, max_wait_ms=30.0,
                                       speculative_max_wait_ms=10_000, time_fn=lambda: clock[0])
    flush_order = []
    original_execute = executor._execute

    def recording_execute(key, slots, reason, placement=None):
        flush_order.append("spec" if all(s.speculative for s in slots) else "live")
        return original_execute(key, slots, reason, placement)

    executor._execute = recording_execute
    results = {}

    def run(tag, designer, speculative):
        results[tag] = executor.suggest(designer, 1, speculative=speculative)

    try:
        spec = [_start(run, tag, _Stub(v, "spec"), True) for tag, v in (("a", 1.0), ("b", 2.0))]
        _wait_for(lambda: executor.queue_depth()["speculative"] == 2)
        live = _start(run, "live", _Stub(3.0, "live"), False)
        _wait_for(lambda: executor.live_pending() == 1)
        clock[0] = 1.0
        with executor._cond:
            executor._cond.notify_all()
        for t in spec + [live]:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in spec + [live])
        assert flush_order[0] == "live", flush_order
        assert set(flush_order) == {"live", "spec"}
        assert sorted(results) == ["a", "b", "live"]
    finally:
        executor.close()


def test_speculative_flushes_in_idle_window():
    executor = texecutor.BatchExecutor(max_batch_size=8, max_wait_ms=5.0)
    try:
        out = executor.suggest(_Stub(1.0, group="spec"), 1, speculative=True)
        assert [s.parameters["x"].value for s in out] == [1.0]
    finally:
        executor.close()


def test_speculative_rides_a_live_flush():
    """A speculative slot in a bucket a live slot joins flushes with the
    live batch: a full flush of 2, both through the batched path."""
    executor = texecutor.BatchExecutor(max_batch_size=2, max_wait_ms=10_000)
    spec, live = _Stub(1.0, group="g"), _Stub(2.0, group="g")
    try:
        t1 = _start(lambda: executor.suggest(spec, 1, speculative=True))
        _wait_for(lambda: executor.queue_depth()["speculative"] == 1)
        t2 = _start(lambda: executor.suggest(live, 1))
        t1.join(timeout=30)
        t2.join(timeout=30)
        assert not t1.is_alive() and not t2.is_alive()
        assert spec.batched and live.batched
    finally:
        executor.close()


def test_starvation_cap_flushes_speculative_under_constant_live():
    """speculative_max_wait_ms bounds the hold: the speculative slot is
    served while the live slot stays parked in its never-due bucket."""
    executor = texecutor.BatchExecutor(max_batch_size=8, max_wait_ms=10_000,
                                       speculative_max_wait_ms=30.0)
    results = {}

    def run(tag, designer, speculative):
        results[tag] = executor.suggest(designer, 1, speculative=speculative)

    t_live = _start(run, "live", _Stub(2.0, group="live"), False)
    try:
        _wait_for(lambda: executor.live_pending() == 1)
        t_spec = _start(run, "spec", _Stub(1.0, group="spec"), True)
        t_spec.join(timeout=10)
        assert not t_spec.is_alive()
        assert results["spec"] is not None and "live" not in results
    finally:
        executor.close()
        t_live.join(timeout=10)
    assert not t_live.is_alive() and results["live"] is not None


def test_close_drains_speculative_slots():
    executor = texecutor.BatchExecutor(max_batch_size=8, max_wait_ms=10_000,
                                       speculative_max_wait_ms=10_000)
    result = []
    t = _start(lambda: result.append(executor.suggest(_Stub(1.0, "spec"), 1, speculative=True)))
    _wait_for(lambda: executor.queue_depth()["speculative"] == 1)
    executor.close()
    t.join(timeout=10)
    assert not t.is_alive() and result and result[0] is not None


def test_an_explicit_lane_name_rides_its_lane():
    """``suggest(..., lane=)`` names a lane of the table; it wins over
    ``speculative``."""
    lanes = [texecutor.LaneSpec("live", 0),
             texecutor.LaneSpec("batchwork", 1, deferrable=True, starvation_cap_ms=10_000.0)]
    executor = texecutor.BatchExecutor(max_batch_size=8, max_wait_ms=10_000, lanes=lanes)
    try:
        t = _start(lambda: executor.suggest(_Stub(1.0, "bw"), 1, speculative=True,
                                            lane="batchwork"))
        _wait_for(lambda: executor.queue_depth() == {"live": 0, "batchwork": 1})
    finally:
        executor.close()
        t.join(timeout=10)
    assert not t.is_alive()
