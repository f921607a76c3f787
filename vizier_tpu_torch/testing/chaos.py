"""Deterministic seeded fault injection (chaos harness).

The port's copy of the JAX package's ``testing/chaos.py``. It extends
``testing/failing.py``'s deliberately-failing designers with
*probabilistic*, *seeded* fault injection at three layers of the stack:

- :class:`ChaosDesigner` — wraps any designer; each ``suggest`` (and
  optionally ``update``) draws from the chaos RNG and raises
  ``failing.FailedSuggestError`` with the configured probability;
- :class:`ChaosDataStore` — wraps a ``DataStore``; configured methods
  raise :class:`InjectedFaultError` (a ``ConnectionError``, so the
  reliability layer classifies it transient) *before* delegating, never
  leaving partial writes behind;
- :class:`ChaosServiceStub` — wraps a service stub / in-process servicer;
  injects transport-shaped faults into RPCs, exercising client retries.

All injection draws come from ONE ``random.Random(seed)`` behind a lock, so
a single-threaded run is exactly reproducible: same seed, same wrapped call
sequence → same faults. Latency injection (``latency_secs`` with
``latency_prob``) simulates slow dependencies for deadline tests.

The port's designers have no ``batch_*`` methods of their own: a
:class:`ChaosDesigner`'s ``batch_*`` methods strike, then run the inner
designer's registered compute-IR program. The wrapper reads through to the
inner designer for every attribute it does not define (the serving
runtime's counters, warm-start and surrogate state), and the surrogate
crossover listener the runtime installs lands on the inner designer, which
fires it.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.compute import ir as compute_ir
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.surrogates import config as surrogate_config_lib
from vizier_tpu_torch.testing import failing


class InjectedFaultError(ConnectionError):
    """A chaos-injected transport/storage fault (classified transient)."""


class ChaosMonkey:
    """The seeded fault source shared by every chaos wrapper in a run."""

    def __init__(
        self,
        *,
        seed: int = 0,
        failure_prob: float = 0.1,
        latency_prob: float = 0.0,
        latency_secs: float = 0.0,
        sleep_fn: Callable[[float], None] = time.sleep,
    ):
        if not 0.0 <= failure_prob <= 1.0:
            raise ValueError(f"failure_prob must be in [0, 1], got {failure_prob}")
        self.seed = seed
        self.failure_prob = failure_prob
        self.latency_prob = latency_prob
        self.latency_secs = latency_secs
        self._sleep_fn = sleep_fn
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # site -> {"calls": n, "faults": n, "latencies": n}
        self._counts: Dict[str, Dict[str, int]] = {}

    def _site(self, site: str) -> Dict[str, int]:
        return self._counts.setdefault(
            site, {"calls": 0, "faults": 0, "latencies": 0}
        )

    def strike(self, site: str) -> None:
        """One injection point: maybe sleep, maybe raise (seeded draws).

        Always draws exactly two variates per call so the fault sequence
        is a pure function of (seed, call index) — independent of which
        probabilities are zero.
        """
        with self._lock:
            counts = self._site(site)
            counts["calls"] += 1
            fail = self._rng.random() < self.failure_prob
            lag = self._rng.random() < self.latency_prob
            if lag:
                counts["latencies"] += 1
            if fail:
                counts["faults"] += 1
        if lag and self.latency_secs > 0:
            self._sleep_fn(self.latency_secs)
        if fail:
            raise InjectedFaultError(f"chaos: injected fault at {site}")

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Per-site injection accounting (copied snapshot)."""
        with self._lock:
            return {site: dict(c) for site, c in self._counts.items()}

    def total_faults(self) -> int:
        with self._lock:
            return sum(c["faults"] for c in self._counts.values())


class ChaosDesigner(core_lib.Designer):
    """Probabilistic-failure wrapper around any designer.

    The probabilistic sibling of ``failing.AlternateFailingDesigner``:
    faults arrive per the chaos RNG instead of every other call, raising
    the same ``failing.FailedSuggestError`` (a *designer* failure, not a
    transport one — the service should degrade, not retry transport).
    """

    def __init__(
        self,
        inner: core_lib.Designer,
        chaos: ChaosMonkey,
        *,
        fail_updates: bool = False,
    ):
        self._inner = inner
        self._chaos = chaos
        self._fail_updates = fail_updates
        # The inner designer's program of the latest resolution.
        self._program: Optional[compute_ir.DesignerProgram] = None

    def __getattr__(self, name: str):
        # Only reached for names the wrapper does not define.
        inner = self.__dict__.get("_inner")
        if inner is None or name.startswith("__"):
            raise AttributeError(name)
        return getattr(inner, name)

    def update(self, completed, all_active=core_lib.ActiveTrials()) -> None:
        if self._fail_updates:
            try:
                self._chaos.strike("designer.update")
            except InjectedFaultError as e:
                raise failing.FailedSuggestError(str(e)) from None
        self._inner.update(completed, all_active)

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        try:
            self._chaos.strike("designer.suggest")
        except InjectedFaultError as e:
            raise failing.FailedSuggestError(str(e)) from None
        return list(self._inner.suggest(count))

    # -- cross-study batch protocol (the compute IR) -------------------------
    # Chaos-wrapped designers stay batchable: ``compute_program`` resolves
    # the inner designer's registered DesignerProgram and wraps it in
    # :class:`ChaosProgram`, so fault injection rides the IR generically —
    # every registered program family (exact, sparse, UCB-PE) inherits
    # slot-isolation chaos without per-designer method copies. A strike in
    # the per-slot host-side hooks (prepare/finalize) degrades only that
    # study; a strike in ``device_program`` poisons the shared device body,
    # driving the executor's whole-batch sequential fallback.

    def compute_program(self, count: Optional[int] = None):
        from vizier_tpu_torch.compute import registry as compute_registry

        resolved = compute_registry.resolve(self._inner, count)
        if resolved is None:
            return None
        program, key = resolved
        self._program = program
        return ChaosProgram(program, self), key

    def _inner_program(self, count: Optional[int] = None) -> compute_ir.DesignerProgram:
        if self._program is None:
            resolved = self.compute_program(count)
            if resolved is None:
                raise ValueError(
                    f"No compute program covers {type(self._inner).__name__}'s state."
                )
        return self._program

    # The duck-typed surface the program routes through (so per-test
    # instance patches of these methods keep working).

    def batch_bucket_key(self, count: Optional[int] = None):
        resolved = self.compute_program(count)
        return resolved[1] if resolved is not None else None

    def batch_prepare(self, count: Optional[int] = None) -> dict:
        try:
            self._chaos.strike("designer.batch_prepare")
        except InjectedFaultError as e:
            raise failing.FailedSuggestError(str(e)) from None
        return self._inner_program(count).prepare(self._inner, count or 1)

    def batch_execute(self, items, pad_to: Optional[int] = None, placement=None):
        self._chaos.strike("designer.batch_execute")
        return self._inner_program().device_program(items, pad_to=pad_to, placement=placement)

    def batch_finalize(self, item: dict, output) -> List[trial_.TrialSuggestion]:
        try:
            self._chaos.strike("designer.batch_finalize")
        except InjectedFaultError as e:
            raise failing.FailedSuggestError(str(e)) from None
        return self._inner_program().finalize(self._inner, item, output)


def _listener_property(name: str) -> property:
    """The runtime's crossover listener, kept on the inner designer (the one
    that fires it)."""
    return property(
        lambda self: getattr(self._inner, name, None),
        lambda self, value: setattr(self._inner, name, value),
    )


setattr(
    ChaosDesigner,
    surrogate_config_lib._CROSSOVER_ATTR,
    _listener_property(surrogate_config_lib._CROSSOVER_ATTR),
)


class ChaosProgram(compute_ir.DesignerProgram):
    """Fault-injecting wrapper over any compute-IR ``DesignerProgram``.

    Wrapping happens at program resolution
    (``ChaosDesigner.compute_program``), so every registered program —
    exact, sparse, UCB-PE — is chaos-testable through one seam. The
    host-side hooks route through the bound chaos designer's striking
    ``batch_*`` methods: a per-slot strike raises designer-shaped
    ``FailedSuggestError`` and degrades only that study; a
    ``device_program`` strike poisons the shared device body, driving the
    executor's whole-batch sequential fallback.
    """

    def __init__(self, inner, chaos_designer: ChaosDesigner):
        self._inner = inner
        self._designer = chaos_designer
        self.kind = inner.kind
        self.algorithms = inner.algorithms
        self.device_phase = getattr(inner, "device_phase", "")
        self.surrogate_family = getattr(inner, "surrogate_family", "exact")
        # Mesh shardability is the wrapped program's call: a chaos-wrapped
        # shardable program runs on its assigned placement, so the strikes
        # reach the mesh dispatch path too.
        self.shardable_batch_axis = getattr(inner, "shardable_batch_axis", "")

    def bucket_key(self, designer, count):
        return self._inner.bucket_key(
            getattr(designer, "_inner", designer), count
        )

    def prepare(self, designer, count):
        return designer.batch_prepare(count)

    def device_program(self, items, pad_to: Optional[int] = None, placement=None):
        return self._designer.batch_execute(
            items, pad_to=pad_to, placement=placement
        )

    def finalize(self, designer, item, output):
        return designer.batch_finalize(item, output)

    def prewarm_factory(self, problem, **kwargs):
        return self._inner.prewarm_factory(problem, **kwargs)


def chaos_designer_factory(
    inner_factory: Callable[..., core_lib.Designer],
    chaos: ChaosMonkey,
    **chaos_kwargs: Any,
) -> Callable[..., core_lib.Designer]:
    """Wraps a designer factory so every built designer is chaos-wrapped."""

    def factory(problem, **kwargs):
        return ChaosDesigner(
            inner_factory(problem, **kwargs), chaos, **chaos_kwargs
        )

    return factory


class _ChaosProxy:
    """Injects a fault before delegating the named methods to ``inner``.

    Fail-fast by design: the strike happens BEFORE the delegate runs, so an
    injected fault never leaves a half-applied write behind — chaos tests
    probe the retry/fallback machinery, not datastore crash atomicity.
    """

    _PREFIX = "proxy"

    def __init__(self, inner: Any, chaos: ChaosMonkey, methods: Sequence[str]):
        self._inner = inner
        self._chaos = chaos
        self._methods = frozenset(methods)

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name not in self._methods or not callable(attr):
            return attr

        def wrapped(*args, **kwargs):
            self._chaos.strike(f"{self._PREFIX}.{name}")
            return attr(*args, **kwargs)

        return wrapped


class ChaosDataStore(_ChaosProxy):
    """Fault-injecting wrapper over any ``DataStore`` implementation."""

    _PREFIX = "datastore"

    DEFAULT_METHODS = (
        "get_trial",
        "list_trials",
        "update_trial",
        "create_trial",
        "max_trial_id",
        "load_study",
    )

    def __init__(
        self,
        inner: Any,
        chaos: ChaosMonkey,
        methods: Sequence[str] = DEFAULT_METHODS,
    ):
        super().__init__(inner, chaos, methods)


class ChaosServiceStub(_ChaosProxy):
    """Fault-injecting wrapper over a Vizier service stub / servicer.

    Simulates transport flakiness between client and service; wrap the
    object handed to ``VizierClient`` with it and the client's RetryPolicy
    absorbs the injected ``InjectedFaultError``s.
    """

    _PREFIX = "rpc"

    DEFAULT_METHODS = (
        "SuggestTrials",
        "GetOperation",
        "GetTrial",
        "ListTrials",
        "AddTrialMeasurement",
        "CompleteTrial",
        "GetStudy",
        "ListOptimalTrials",
    )

    def __init__(
        self,
        inner: Any,
        chaos: ChaosMonkey,
        methods: Sequence[str] = DEFAULT_METHODS,
    ):
        super().__init__(inner, chaos, methods)
