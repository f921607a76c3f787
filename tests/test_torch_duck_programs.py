"""The duck-typed program seam, held to the JAX package on the CPU.

A designer with no registered program that exposes ``batch_bucket_key`` /
``batch_prepare`` / ``batch_execute`` / ``batch_finalize`` resolves to a
``DuckTypedProgram`` and batches through the executor, in both packages:

- ``tests/compute/test_ir_registry.py``'s ``Duck`` through both registries;
- the stub family of ``tests/parallel/test_batch_executor.py`` (a batchable
  stub, an unbatchable one, group statics, a failing prepare, a failing
  device program, a non-finite decode) through both executors, a port twin
  of each stub: the same flushes, studies per device program and its
  padding, fallbacks, slot errors, sequential calls and outputs;
- a wrapper that forwards the four hooks to the port's GP-UCB-PE batches
  through ``DuckTypedProgram``, its suggestions equal float for float to the
  registered program's flush of the same studies;
- the GP designers' own ``batch_*`` hooks: the bucket keys ``resolve``
  gives, and a flush through the hooks equal to each study alone.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.compute import ir as jir
from vizier_tpu.compute import registry as jregistry
from vizier_tpu.designers import gp_bandit as jbandit
from vizier_tpu.designers import gp_ucb_pe as jucb
from vizier_tpu.parallel import batch_executor as jexecutor
from vizier_tpu.serving import stats as jstats
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.compute import ir as tir
from vizier_tpu_torch.compute import registry as tregistry
from vizier_tpu_torch.designers import gp_bandit as tbandit
from vizier_tpu_torch.designers import gp_ucb_pe as tucb
from vizier_tpu_torch.optimizers import lbfgs as tlbfgs
from vizier_tpu_torch.parallel import batch_executor as texecutor
from vizier_tpu_torch.serving import stats as tstats
from vizier_tpu_torch.surrogates import config as tconfig

# Each package's (pyvizier, compute IR, registry, executor module, stats).
_PACKAGES = {
    "jax": (jvz, jir, jregistry, jexecutor, jstats),
    "torch": (tvz, tir, tregistry, texecutor, tstats),
}
_COUNTERS = ("batch_flushes", "batched_suggests", "batch_fallbacks", "batch_slot_errors")


# -- the registries: test_ir_registry.py's Duck --------------------------------


def _duck_class(ir):
    class Duck:
        def suggest(self, count=1):
            return ["s"] * (count or 1)

        def batch_bucket_key(self, count=1):
            return ir.BucketKey(kind="duck", pad_trials=8, cont_width=1, cat_width=0,
                                metric_count=1, count=count or 1)

        def batch_prepare(self, count=1):
            return dict(designer=self, count=count)

        def batch_execute(self, items, pad_to=None):
            return [dict(v=1) for _ in items]

        def batch_finalize(self, item, output):
            return ["done"] * item["count"]

    return Duck


@pytest.mark.parametrize("package", sorted(_PACKAGES))
def test_a_duck_typed_designer_resolves_to_the_adapter(package):
    _, ir, registry, _, _ = _PACKAGES[package]
    duck = _duck_class(ir)()
    resolved = registry.resolve(duck, 2)
    assert resolved is not None, f"{package}: the duck-typed designer is not batchable"
    program, key = resolved
    assert isinstance(program, registry.DuckTypedProgram)
    assert (key.kind, program.kind, program.device_phase, program.surrogate_family) == (
        "duck", "duck", "duck.suggest_batched", "exact")
    item = program.prepare(duck, 2)
    out = program.device_program([item])
    assert program.finalize(duck, item, out[0]) == ["done", "done"]
    with pytest.raises(NotImplementedError, match="not prewarmable"):
        program.prewarm_factory(None)


@pytest.mark.parametrize("package", sorted(_PACKAGES))
def test_a_declining_hook_and_a_plain_designer_resolve_none(package):
    _, ir, registry, _, _ = _PACKAGES[package]

    class Declines(_duck_class(ir)):
        def batch_bucket_key(self, count=1):
            return None

    class Plain:
        def suggest(self, count=1):
            return []

    assert registry.resolve(Declines(), 1) is None
    assert registry.resolve(Plain(), 1) is None


@pytest.mark.parametrize("package", sorted(_PACKAGES))
def test_a_registered_type_that_declines_does_not_fall_to_the_duck_hooks(package):
    """Registered programs come before the hooks: a GP designer in its
    seeding stage has hooks, but its programs decline it, so None."""
    registry = _PACKAGES[package][2]
    designer = _gp(package, "gp_bandit", 0, trials=0)
    assert hasattr(designer, "batch_bucket_key")
    assert registry.resolve(designer, 1) is None
    assert designer.batch_bucket_key(1) is None


def test_the_adapter_passes_a_placement_only_to_a_hook_that_takes_one():
    seen = []

    class WithPlacement(_duck_class(tir)):
        def batch_execute(self, items, pad_to=None, placement=None):
            seen.append((pad_to, placement))
            return [dict(v=1) for _ in items]

    for duck, placement in ((WithPlacement(), "mesh0"), (_duck_class(tir)(), "mesh0")):
        program, _ = tregistry.resolve(duck, 1)
        assert len(program.device_program([duck.batch_prepare(1)], pad_to=4,
                                          placement=placement)) == 1
    assert seen == [(4, "mesh0")]


def test_the_adapter_dispatches_through_the_resolved_designer():
    """A wrapper's ``batch_execute`` stays on the device path even though the
    items record the inner designer."""
    calls = []
    inner = _duck_class(tir)()

    class Wrapper:
        def suggest(self, count=1):
            return inner.suggest(count)

        def batch_bucket_key(self, count=1):
            return inner.batch_bucket_key(count)

        def batch_prepare(self, count=1):
            return inner.batch_prepare(count)

        def batch_execute(self, items, pad_to=None):
            calls.append(len(items))
            return inner.batch_execute(items, pad_to=pad_to)

        def batch_finalize(self, item, output):
            return inner.batch_finalize(item, output)

    wrapper = Wrapper()
    program, _ = tregistry.resolve(wrapper, 1)
    items = [wrapper.batch_prepare(1), wrapper.batch_prepare(1)]
    assert all(item["designer"] is inner for item in items)
    assert len(program.device_program(items)) == 2 and calls == [2]


# -- the executors: test_batch_executor.py's stub family --------------------------


def _stub_classes(package):
    """The JAX test's StubDesigner family, over ``package``'s pyvizier and
    BucketKey; every stub records its device programs' (studies, pad_to)."""
    vz, ir, _, _, _ = _PACKAGES[package]

    def suggestion(value):
        return vz.TrialSuggestion(parameters={"x": float(value)})

    class StubDesigner:
        def __init__(self, value, group="g", batchable=True, executes=None):
            self.value = value
            self.group = group
            self.batchable = batchable
            self.sequential_calls = 0
            self.batched = False
            self.executes = executes if executes is not None else []

        def suggest(self, count=1):
            self.sequential_calls += 1
            return [suggestion(self.value)] * (count or 1)

        def batch_bucket_key(self, count=1):
            if not self.batchable:
                return None
            return ir.BucketKey(kind="stub", pad_trials=8, cont_width=1, cat_width=0,
                                metric_count=1, count=count or 1, statics=(self.group,))

        def batch_prepare(self, count=1):
            return dict(designer=self, count=count or 1, value=self.value)

        def batch_execute(self, items, pad_to=None):
            self.executes.append((len(items), pad_to))
            return [dict(value=item["value"]) for item in items]

        def batch_finalize(self, item, output):
            self.batched = True
            return [suggestion(output["value"])] * item["count"]

    class FailPrepareStub(StubDesigner):
        def batch_prepare(self, count=1):
            raise RuntimeError("prepare exploded")

    class FailExecuteStub(StubDesigner):
        def batch_execute(self, items, pad_to=None):
            self.executes.append((len(items), pad_to))
            raise RuntimeError("device program exploded")

    class NanStub(StubDesigner):
        def batch_finalize(self, item, output):
            return [suggestion(float("nan"))]

    return dict(stub=StubDesigner, fail_prepare=FailPrepareStub,
                fail_execute=FailExecuteStub, nan=NanStub)


# Each case: the executor's (max batch size, window ms), then the studies as
# (stub kind, value, group, batchable), the JAX test it mirrors in its name.
_CASES = {
    "full_flush_batches_and_demuxes": ((3, 5000), [("stub", 0.1, "g", True),
                                                   ("stub", 0.2, "g", True),
                                                   ("stub", 0.3, "g", True)]),
    "timeout_flush_singleton_takes_sequential_path": ((8, 10), [("stub", 0.7, "g", True)]),
    "unbatchable_runs_inline": ((4, 5000), [("stub", 0.4, "g", False)]),
    "different_groups_do_not_batch": ((2, 50), [("stub", 0.1, "g1", True),
                                                ("stub", 0.2, "g2", True)]),
    "prepare_fault_isolated_to_its_slot": ((3, 1000), [("stub", 0.1, "g", True),
                                                       ("stub", 0.2, "g", True),
                                                       ("fail_prepare", 0.9, "g", True)]),
    "execute_failure_falls_back_to_sequential_per_slot": (
        (2, 5000), [("fail_execute", 0.3, "g", True), ("fail_execute", 0.6, "g", True)]),
    "nan_slot_gets_typed_transient_error": ((2, 5000), [("stub", 0.5, "g", True),
                                                        ("nan", 0.5, "g", True)]),
}


def _run_case(package, case, count=1):
    """The case through ``package``'s executor, every study on its own thread
    released at once. Returns what both packages must agree on."""
    _, _, _, executor_lib, stats_lib = _PACKAGES[package]
    (max_batch, window), studies = _CASES[case]
    classes = _stub_classes(package)
    executes = []
    designers = [classes[kind](value, group=group, batchable=batchable, executes=executes)
                 for kind, value, group, batchable in studies]
    stats = stats_lib.ServingStats()
    executor = executor_lib.BatchExecutor(max_batch_size=max_batch, max_wait_ms=window,
                                          stats=stats, metrics=stats.registry)
    results, errors = [None] * len(designers), [None] * len(designers)
    barrier = threading.Barrier(len(designers))

    def run(i):
        barrier.wait()
        try:
            results[i] = executor.suggest(designers[i], count)
        except Exception as e:  # noqa: BLE001 - compared below
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(designers))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        executor.close()
    assert not any(t.is_alive() for t in threads)
    snap = stats.snapshot()
    return dict(
        counters={k: snap[k] for k in _COUNTERS},
        device_programs=sorted(executes),
        outputs=[None if r is None else [s.parameters.as_dict()["x"] for s in r]
                 for r in results],
        errors=[None if e is None else type(e).__name__ for e in errors],
        transient=[e is not None and "TRANSIENT" in str(e) for e in errors],
        sequential_calls=[d.sequential_calls for d in designers],
        batched=[d.batched for d in designers],
    )


@pytest.mark.parametrize("case", sorted(_CASES))
def test_the_stub_family_flushes_alike_in_both_executors(case):
    want = _run_case("jax", case)
    got = _run_case("torch", case)
    assert got["counters"] == want["counters"]
    assert got["device_programs"] == want["device_programs"]
    assert got["errors"] == want["errors"]
    assert got["transient"] == want["transient"]
    assert got["sequential_calls"] == want["sequential_calls"]
    assert got["batched"] == want["batched"]
    for g, w in zip(got["outputs"], want["outputs"]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


# -- the GP designers' hooks ----------------------------------------------------

_FAST = dict(ard_restarts=2, max_acquisition_evaluations=300, warm_start_min_trials=0)
_SPARSE = dict(sparse_threshold_trials=10, hysteresis_trials=2, num_inducing=6)


def _problem(vz):
    p = vz.ProblemStatement()
    for j in range(3):
        p.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    p.metric_information.append(vz.MetricInformation(name="y", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return p


def _trials(vz, seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.uniform(size=3)
        t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[j]) for j in range(3)})
        t.complete(vz.Measurement(metrics={"y": float(-np.sum((x - 0.5) ** 2) + 0.1 * rng.normal())}))
        out.append(t)
    return out


def _gp(package, kind, seed, trials=12, sparse=False):
    """A GP designer of ``package`` with ``trials`` completed trials."""
    vz = _PACKAGES[package][0]
    if package == "jax":
        from vizier_tpu.optimizers import lbfgs as jlbfgs
        from vizier_tpu.surrogates import config as jconfig

        cls = jucb.VizierGPUCBPEBandit if kind == "gp_ucb_pe" else jbandit.VizierGPBandit
        kw = dict(ard_optimizer=jlbfgs.AdamOptimizer(maxiter=15))
        if sparse:
            kw["surrogate"] = jconfig.SurrogateConfig(**_SPARSE)
    else:
        cls = tucb.VizierGPUCBPEBandit if kind == "gp_ucb_pe" else tbandit.VizierGPBandit
        kw = dict(device="cpu", ard_optimizer=tlbfgs.AdamOptimizer(maxiter=15, device="cpu"))
        if sparse:
            kw["surrogate"] = tconfig.SurrogateConfig(**_SPARSE)
    designer = cls(_problem(vz), rng_seed=seed, **_FAST, **kw)
    if trials:
        designer.update(vz.CompletedTrials(_trials(vz, seed, trials)), vz.ActiveTrials())
    return designer


def _shape(key):
    return None if key is None else (key.kind, key.pad_trials, key.cont_width, key.cat_width,
                                     key.metric_count, key.count)


@pytest.mark.parametrize("sparse", [False, True], ids=["exact", "sparse"])
@pytest.mark.parametrize("kind", ["gp_bandit", "gp_ucb_pe"])
def test_the_designers_hooks_give_the_keys_resolve_gives(kind, sparse):
    for count in (1, 3):
        keys = {}
        for package in ("jax", "torch"):
            registry = _PACKAGES[package][2]
            designer = _gp(package, kind, seed=1, sparse=sparse)
            key = designer.batch_bucket_key(count)
            program, resolved = registry.resolve(designer, count)
            assert key == resolved and program.kind == key.kind
            assert designer._active_batch_program() is program
            keys[package] = _shape(key)
        want_kind = kind + ("_sparse" if sparse else "")
        assert keys["torch"] == keys["jax"] and keys["torch"][0] == want_kind


def _values(suggestions):
    return [s.parameters.as_dict() for s in suggestions]


@pytest.mark.parametrize("sparse", [False, True], ids=["exact", "sparse"])
@pytest.mark.parametrize("kind", ["gp_bandit", "gp_ucb_pe"])
def test_a_flush_through_the_hooks_equals_each_study_alone(kind, sparse):
    """The JAX test's batched-vs-sequential parity, through the designers'
    own hooks as the executor calls them: the bucket key (which refreshes the
    surrogate mode), prepare, the class's execute padded to 4, finalize."""
    seeds = (11, 12)
    want = [_values(_gp("torch", kind, s, sparse=sparse).suggest(2)) for s in seeds]
    batched = [_gp("torch", kind, s, sparse=sparse) for s in seeds]
    assert len({d.batch_bucket_key(2) for d in batched}) == 1
    items = [d.batch_prepare(2) for d in batched]
    assert all(item["sparse"] == sparse for item in items)
    outputs = type(batched[0]).batch_execute(items, pad_to=4)
    got = [_values(d.batch_finalize(i, o)) for d, i, o in zip(batched, items, outputs)]
    assert got == want


class _Forwarding:
    """An out-of-tree designer: not registered, no ``compute_program``; its
    four hooks forward to the wrapped designer's."""

    def __init__(self, inner):
        self.inner = inner

    def suggest(self, count=None):
        return self.inner.suggest(count)

    def batch_bucket_key(self, count=None):
        return self.inner.batch_bucket_key(count)

    def batch_prepare(self, count=None):
        return self.inner.batch_prepare(count)

    def batch_execute(self, items, pad_to=None):
        return self.inner.batch_execute(items, pad_to=pad_to)

    def batch_finalize(self, item, output):
        return self.inner.batch_finalize(item, output)


def _ordered_flush(designers, count):
    """One flush of ``designers`` in this order through a fresh port executor
    (each submitted once the one before is queued). Returns (suggestions,
    counters, the resolved program types)."""
    stats = tstats.ServingStats()
    executor = texecutor.BatchExecutor(max_batch_size=len(designers), max_wait_ms=30_000,
                                       stats=stats)
    programs = [type(tregistry.resolve(d, count)[0]).__name__ for d in designers]
    results, errors = [None] * len(designers), []

    def run(i):
        try:
            results[i] = executor.suggest(designers[i], count)
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = []
    try:
        for i in range(len(designers)):
            threads.append(threading.Thread(target=run, args=(i,)))
            threads[-1].start()
            deadline = time.time() + 30
            while (i + 1 < len(designers) and sum(executor.pending_counts().values()) <= i
                   and time.time() < deadline):
                time.sleep(0.002)
        for t in threads:
            t.join(timeout=120)
    finally:
        executor.close()
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    snap = stats.snapshot()
    return results, {k: snap[k] for k in _COUNTERS}, programs


def test_a_forwarding_wrapper_batches_a_gp_designer_as_its_registered_program():
    seeds = (5, 6)
    ducks = [_Forwarding(_gp("torch", "gp_ucb_pe", s)) for s in seeds]
    got, counters, programs = _ordered_flush(ducks, 2)
    assert programs == ["DuckTypedProgram"] * 2
    assert counters == dict(batch_flushes=1, batched_suggests=2, batch_fallbacks=0,
                            batch_slot_errors=0)
    want, want_counters, want_programs = _ordered_flush(
        [_gp("torch", "gp_ucb_pe", s) for s in seeds], 2)
    assert want_programs == ["UCBPEProgram"] * 2 and want_counters == counters
    assert [_values(r) for r in got] == [_values(r) for r in want]
    acquisition = [[s.metadata.ns("gp_ucb_pe")["acquisition"] for s in r] for r in got]
    assert acquisition == [[s.metadata.ns("gp_ucb_pe")["acquisition"] for s in r] for r in want]
