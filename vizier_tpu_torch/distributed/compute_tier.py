"""Disaggregated compute tier: frontends share ONE remote Pythia server.

A copy of the JAX package's ``distributed/compute_tier.py``. The Vizier
architecture separates the Pythia algorithm service from the Vizier DB
service so algorithm compute scales independently of traffic ("The Vizier
Gaussian Process Bandit Algorithm", arXiv:2408.11527 §4; the
``DistributedPythiaVizierServer`` topology). The subprocess
fleet gives every ``replica_main`` its OWN in-process Pythia, so the
cross-study batch executor, designer cache, and speculative engine
amortize only within one process. This module is the other topology: N
frontend replicas dispatch Pythia work over the EXISTING ``PythiaService``
gRPC surface to one standalone compute server
(``distributed.pythia_server_main``) hosting one shared
:class:`~vizier_tpu_torch.service.pythia_service.PythiaServicer` — one designer
cache, one batch executor whose shape buckets fuse concurrent suggests
from the WHOLE fleet into single batched flushes on the card (occupancy ≈
N frontends instead of N singleton flushes).

:class:`RemotePythiaStub` is the frontend half: a duck-typed drop-in for
``VizierServicer.set_pythia`` that forwards ``Suggest``/``EarlyStop`` to
the tier under the reliability plane's :class:`RetryPolicy` and the
request's propagated deadline budget, and **degrades gracefully** — when
the tier is unreachable it serves from the frontend's local minimal
Pythia (``fallback="local"``), enters a cooldown so the hot path never
re-blocks on a dead endpoint, and re-probes after
``health_interval_s``. ``trace_context`` is re-stamped across the hop
with a ``compute_tier.remote_suggest`` span carrying
``frontend=<replica_id>``, so a merged fleet dump
(``observability.fleet``) stitches frontend→compute-tier traces.

Off-switch semantics: with ``VIZIER_TORCH_COMPUTE_TIER=0`` (the default) no
stub is constructed anywhere and every frontend serves from its own
in-process Pythia.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional

from vizier_tpu_torch.utils import env as env_registry
from vizier_tpu_torch.reliability import deadline as deadline_lib
from vizier_tpu_torch.reliability import errors as errors_lib
from vizier_tpu_torch.reliability import retry as retry_lib

try:  # the fleet's hosts have grpc; keep importable without it.
    import grpc
except ImportError:  # pragma: no cover - service extras absent
    grpc = None  # type: ignore[assignment]

# Seconds a connect attempt (channel-ready wait) may block a probing
# request. Deliberately short: the only caller that pays it is the first
# request after a cooldown expires, and the local fallback is one
# exception away.
CONNECT_TIMEOUT_S = 2.0


@dataclasses.dataclass(frozen=True)
class ComputeTierConfig:
    """The frontend-side compute-tier switches (VIZIER_TORCH_COMPUTE_TIER*)."""

    enabled: bool = False
    # host:port of the shared Pythia compute server. Empty with the tier
    # enabled behaves as "tier down": every request takes the fallback.
    endpoint: str = ""
    # "local" — serve from the frontend's own minimal Pythia when the
    # tier is unreachable; "fail" — surface the transport error.
    fallback: str = "local"
    # Cooldown after a tier failure before the next remote re-probe.
    health_interval_s: float = 1.0

    def __post_init__(self):
        if self.fallback not in ("local", "fail"):
            raise ValueError(
                f"ComputeTierConfig.fallback must be 'local' or 'fail', "
                f"got {self.fallback!r}."
            )

    @classmethod
    def from_env(cls) -> "ComputeTierConfig":
        return cls(
            enabled=env_registry.env_on("VIZIER_TORCH_COMPUTE_TIER", "0"),
            endpoint=env_registry.env_str("VIZIER_TORCH_COMPUTE_TIER_ENDPOINT"),
            fallback=env_registry.env_str(
                "VIZIER_TORCH_COMPUTE_TIER_FALLBACK", "local"
            ),
            health_interval_s=env_registry.env_float(
                "VIZIER_TORCH_COMPUTE_TIER_HEALTH_INTERVAL_S", 1.0
            ),
        )


def _is_tier_unreachable(error: BaseException) -> bool:
    """Transport-level failures that mean "the tier, not the request".

    Semantic errors (NotFoundError, ValueError — already translated by the
    stub layer) and designer failures that the COMPUTE SERVER handled (it
    has its own breaker/fallback plane) must propagate unchanged; only the
    hop itself failing engages the frontend's degradation path.
    """
    if isinstance(error, (ConnectionError, TimeoutError)):
        return True
    if isinstance(error, ValueError) and "closed channel" in str(error):
        # A concurrent request's failure path evicted the shared channel
        # (``close_channel`` in ``_note_tier_down``) while this call was
        # in flight: grpcio surfaces that as ``ValueError: Cannot invoke
        # RPC on closed channel!`` — the tier is down, not the request.
        return True
    if grpc is None:  # pragma: no cover - service extras absent
        return False
    if isinstance(error, grpc.FutureTimeoutError):
        return True  # channel never became ready (server down at connect)
    if isinstance(error, grpc.RpcError):
        code = error.code() if hasattr(error, "code") else None
        return code in (
            grpc.StatusCode.UNAVAILABLE,
            grpc.StatusCode.DEADLINE_EXCEEDED,
            grpc.StatusCode.CANCELLED,
        )
    return False


class RemotePythiaStub:
    """Frontend-side Pythia endpoint that dispatches to the compute tier.

    Duck-typed drop-in for ``VizierServicer.set_pythia``: the servicer
    surface (``Suggest``/``EarlyStop``/``Ping``) goes remote; the
    state-management surface (``invalidate_study``, ``notify_trial_event``,
    ``serving_runtime``, ``serving_stats``) stays LOCAL — the shared tier
    has no invalidation RPC, so it detects config turnover itself by
    keying its caches on ``(study_name, config_hash)`` (see
    ``PythiaServicer._parsed_study_config``).

    Lock order: ``_lock`` is a LEAF — counter/cooldown bookkeeping only;
    stub construction and every RPC run outside it.
    """

    def __init__(
        self,
        endpoint: str,
        *,
        local: Any = None,
        replica_id: str = "",
        config: Optional[ComputeTierConfig] = None,
        retry_policy: Optional[retry_lib.RetryPolicy] = None,
        stub_factory: Optional[Callable[[], Any]] = None,
        time_fn: Callable[[], float] = time.monotonic,
    ):
        self._endpoint = endpoint
        self._local = local
        self._replica_id = replica_id
        self._config = config or ComputeTierConfig(
            enabled=True, endpoint=endpoint
        )
        # Tight retry budget: the tier hop sits INSIDE the service's own
        # dispatch deadline, and the local fallback is the real second
        # attempt. One quick in-hop retry absorbs connection blips.
        self._retry = retry_policy or retry_lib.RetryPolicy(
            max_attempts=2, base_delay_secs=0.05, max_delay_secs=0.25
        )
        self._stub_factory = stub_factory or self._default_stub_factory
        self._time = time_fn
        self._lock = threading.Lock()  # LEAF: bookkeeping only, no RPC.
        self._remote: Any = None
        self._down_until = 0.0
        self._remote_calls = 0
        self._remote_failures = 0
        self._fallback_serves = 0
        self._reconnects = 0

    # -- remote plumbing ---------------------------------------------------

    def _default_stub_factory(self):
        from vizier_tpu_torch.service import grpc_stubs

        return grpc_stubs.create_pythia_stub(
            self._endpoint, timeout=CONNECT_TIMEOUT_S
        )

    def _remote_stub(self):
        """The cached Pythia stub; (re)built OUTSIDE the leaf lock —
        ``create_pythia_stub`` blocks on channel readiness."""
        with self._lock:
            remote = self._remote
        if remote is not None:
            return remote
        built = self._stub_factory()
        with self._lock:
            if self._remote is None:
                self._remote = built
                self._reconnects += 1
            return self._remote

    def _cooling_down(self) -> bool:
        if not self._endpoint:
            return True  # no endpoint configured: permanently "down"
        now = self._time()
        with self._lock:
            return now < self._down_until

    def _note_tier_down(self, error: BaseException) -> None:
        """Failure bookkeeping + channel eviction + cooldown arm."""
        from vizier_tpu_torch.observability import flight_recorder as recorder_lib
        from vizier_tpu_torch.service import grpc_stubs

        if self._endpoint:
            # The shared channel may be wedged on a dead server; evict so
            # the post-cooldown probe reconnects instead of re-timing-out.
            grpc_stubs.close_channel(self._endpoint)
        with self._lock:
            self._remote = None
            self._remote_failures += 1
            self._down_until = self._time() + max(
                0.0, self._config.health_interval_s
            )
        recorder_lib.get_recorder().record(
            None,
            "compute_tier_down",
            frontend=self._replica_id,
            endpoint=self._endpoint,
            error=errors_lib.format_op_error(error),
        )

    def _fallback(self, method: str, request, error: Optional[BaseException]):
        from vizier_tpu_torch.observability import tracing as tracing_lib

        if self._config.fallback != "local" or self._local is None:
            if error is not None:
                raise error
            raise errors_lib.TransientError(
                errors_lib.mark_transient(
                    f"Compute tier {self._endpoint or '(unset)'} unavailable "
                    f"and fallback={self._config.fallback!r}."
                )
            )
        with self._lock:
            self._fallback_serves += 1
        tracing_lib.add_current_event(
            "compute_tier.fallback",
            method=method,
            endpoint=self._endpoint,
            frontend=self._replica_id,
        )
        return getattr(self._local, method)(request)

    def _dispatch(self, method: str, request, span_name: str):
        from vizier_tpu_torch.observability import tracing as tracing_lib

        tracer = tracing_lib.get_tracer()
        parent = tracing_lib.parse_context(
            getattr(request, "trace_context", "")
        )
        with tracer.span(
            span_name,
            parent=parent,
            frontend=self._replica_id,
            endpoint=self._endpoint,
            study=getattr(request, "study_name", ""),
        ) as span:
            # Re-stamp the wire context so the compute server's spans
            # parent under THIS frontend-attributed hop span — that is
            # what lets the fleet merge compute per-frontend fan-in.
            if hasattr(request, "trace_context"):
                request.trace_context = tracing_lib.format_context(
                    span.context()
                )
            if self._cooling_down():
                span.set_attribute("fallback", True)
                return self._fallback(method, request, None)
            deadline = deadline_lib.Deadline.from_wire(
                getattr(request, "deadline_secs", 0.0)
            )
            try:
                remote = self._remote_stub()
                response = self._retry.call(
                    lambda: getattr(remote, method)(request),
                    deadline=deadline if deadline.is_set else None,
                )
            except Exception as e:  # noqa: BLE001 - classified below
                if not _is_tier_unreachable(e):
                    raise
                self._note_tier_down(e)
                span.set_attribute("fallback", True)
                return self._fallback(method, request, e)
            with self._lock:
                self._remote_calls += 1
            return response

    # -- the PythiaService surface ----------------------------------------

    def Suggest(self, request, context=None):
        del context
        return self._dispatch("Suggest", request, "compute_tier.remote_suggest")

    def EarlyStop(self, request, context=None):
        del context
        return self._dispatch(
            "EarlyStop", request, "compute_tier.remote_early_stop"
        )

    def Ping(self, request, context=None):
        del context
        if not self._cooling_down():
            try:
                return self._remote_stub().Ping(request)
            except Exception as e:  # noqa: BLE001 - classified below
                if not _is_tier_unreachable(e):
                    raise
                self._note_tier_down(e)
        return self._fallback("Ping", request, None)

    # -- local state-management surface (duck-typed by VizierServicer) -----

    @property
    def serving_runtime(self):
        return getattr(self._local, "serving_runtime", None)

    def invalidate_study(self, study_name: str) -> None:
        invalidate = getattr(self._local, "invalidate_study", None)
        if invalidate is not None:
            invalidate(study_name)

    def notify_trial_event(self, *args, **kwargs) -> None:
        notify = getattr(self._local, "notify_trial_event", None)
        if notify is not None:
            notify(*args, **kwargs)

    def stats(self) -> dict:
        with self._lock:
            return {
                "endpoint": self._endpoint,
                "remote_calls": self._remote_calls,
                "remote_failures": self._remote_failures,
                "fallback_serves": self._fallback_serves,
                "reconnects": self._reconnects,
                "cooling_down": self._time() < self._down_until,
            }

    def serving_stats(self) -> dict:
        base = {}
        local_stats = getattr(self._local, "serving_stats", None)
        if local_stats is not None:
            base = dict(local_stats())
        base["compute_tier"] = self.stats()
        return base

    def shutdown(self) -> None:
        from vizier_tpu_torch.service import grpc_stubs

        local_shutdown = getattr(self._local, "shutdown", None)
        if local_shutdown is not None:
            local_shutdown()
        if self._endpoint:
            grpc_stubs.close_channel(self._endpoint)


def maybe_wrap_pythia(
    local_pythia,
    *,
    replica_id: str = "",
    endpoint: str = "",
    config: Optional[ComputeTierConfig] = None,
) -> Any:
    """``local_pythia`` unchanged when the tier is off (the default), else a
    :class:`RemotePythiaStub` fronting it.

    ``endpoint`` (e.g. from ``replica_main --compute-endpoint``) overrides
    the config's; a non-empty explicit endpoint also implies enablement so
    the fleet manager can arm frontends by flag alone.
    """
    cfg = config or ComputeTierConfig.from_env()
    target = endpoint or cfg.endpoint
    if not (cfg.enabled or endpoint) or not target:
        return local_pythia
    if cfg.endpoint != target or not cfg.enabled:
        cfg = dataclasses.replace(cfg, enabled=True, endpoint=target)
    return RemotePythiaStub(
        target, local=local_pythia, replica_id=replica_id, config=cfg
    )
