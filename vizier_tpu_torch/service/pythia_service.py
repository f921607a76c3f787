"""PythiaServicer: hosts suggestion policies.

A copy of the JAX package's ``service/pythia_service.py``: builds a
``ServicePolicySupporter`` for the study, asks the policy factory for the
algorithm's policy, converts proto⇄pythia types, and captures policy errors
into the response. Around the live computation it keeps the JAX servicer's
order: request coalescing, then the study's circuit breaker, the deadline
check before dispatch, the designer, the deadline check after it, and the
seeded quasi-random fallback on a designer failure or an open circuit.
Before that come the runtime's opt-in planes: the speculative serve check
(a parked batch computed after the last completion, served stamped
``speculative=hit`` when the frontier still matches) and the admission gate
(admit, shed with a retry-after hint, or serve a low-priority tenant the
stamped quasi-random fallback). That whole order lives in the proto-free
``ServingRuntime.serve_suggest``, which the loadgen's runtime transport and
the GPU smoke run drive too; this servicer only adapts protos to it.

``device`` is where the default factory's designers run: CUDA unless the
caller asks for the CPU, and the servicer raises at construction when CUDA
is asked for and no GPU is present. ``connect_to_vizier`` is the fleet's
late binding: a shared compute tier builds its Pythia first and binds it to
a Vizier service afterwards (``distributed/replica_manager.py``,
``distributed/pythia_server_main.py``). The JAX servicer's compile prewarm
is not ported.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
import traceback
from typing import Optional

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.pythia import policy as policy_lib
from vizier_tpu_torch.reliability import errors as errors_lib
from vizier_tpu_torch.reliability import fallback as fallback_lib
from vizier_tpu_torch.service import policy_factory as policy_factory_lib
from vizier_tpu_torch.service import proto_converters as pc
from vizier_tpu_torch.service import pyvizier as vz
from vizier_tpu_torch.service import service_policy_supporter
from vizier_tpu_torch.service.protos import pythia_service_pb2, study_pb2
from vizier_tpu_torch.service.protos import vizier_service_pb2
from vizier_tpu_torch.serving import coalescer as coalescer_lib
from vizier_tpu_torch.serving import runtime as serving_runtime_lib
from vizier_tpu_torch.serving import speculative as speculative_lib

_logger = logging.getLogger(__name__)


def _config_hash(request) -> str:
    """The request's StudySpec hash: the identity of one config incarnation."""
    spec_bytes = request.study_descriptor.config.SerializeToString()
    return hashlib.sha1(spec_bytes).hexdigest()[:16]


class PythiaServicer:
    def __init__(
        self,
        vizier_service=None,
        policy_factory=None,
        serving_config=None,
        reliability_config=None,
        surrogate_config=None,
        mesh_config=None,
        admission_config=None,
        *,
        device: device_lib.DeviceLike = "cuda",
    ):
        self._vizier = vizier_service
        self.device = device_lib.resolve(device)
        # The stateful serving runtime (designer cache + coalescer + stats +
        # per-study circuit breakers); ``serving_config`` and
        # ``reliability_config`` disable parts or all of it;
        # ``surrogate_config`` sets the exact↔sparse auto-switch every GP
        # designer shares; ``admission_config`` arms the multi-tenant
        # overload-protection plane (off = the path without admission);
        # ``mesh_config`` the mesh execution plane over the servicer's device
        # type. None -> defaults with env-var overrides.
        self._serving = serving_runtime_lib.ServingRuntime(
            serving_config,
            reliability=reliability_config,
            surrogates=surrogate_config,
            mesh=mesh_config,
            admission=admission_config,
            device=self.device,
        )
        self._policy_factory = policy_factory or policy_factory_lib.DefaultPolicyFactory(
            serving_runtime=self._serving, device=self.device
        )
        # Cache for policies that declare should_be_cached, keyed by
        # (study_name, algorithm, config_hash).
        self._policy_cache = {}
        # study_name -> (config hash, parsed StudyConfig). The hash (over
        # the serialized StudySpec) catches metadata updates and the
        # delete/recreate turnover, so the hot path skips a proto->pyvizier
        # parse per suggest without ever serving a stale search space.
        self._config_cache = {}
        # Early-stopping policies cached per study (the regression rule
        # holds a trained boosted-tree regressor; see EarlyStop).
        self._stopping_policies = {}
        self._bind_speculative()

    def connect_to_vizier(self, vizier_service) -> None:
        self._vizier = vizier_service
        self._bind_speculative()

    def _bind_speculative(self) -> None:
        """Connects the runtime's speculative engine to this servicer's
        compute path (needs a Vizier service to read frontiers from)."""
        if self._vizier is None:
            return
        self._serving.bind_speculative(
            self._speculative_fingerprint, self._speculative_compute, self._speculative_accept
        )

    @property
    def serving_runtime(self) -> serving_runtime_lib.ServingRuntime:
        return self._serving

    def serving_stats(self) -> dict:
        """Snapshot of the serving counters + current cache population."""
        return self._serving.snapshot()

    def prometheus_text(self) -> str:
        """Serving counters + latency histograms, Prometheus text format."""
        return self._serving.prometheus_text()

    def prewarm(self, study_config, algorithm: str = "DEFAULT", counts=(1,),
                max_trials=None) -> list:
        """Prewarms the (batched) suggest programs for this study shape.

        Walks the padding-bucket grid at batch sizes {1, max}, so a server
        prewarmed for its expected study shapes captures no CUDA graph on
        the first real request of a bucket. The designer factory comes from
        the compute-IR registry: every registered program claiming
        ``algorithm`` contributes its ``prewarm_factory``. Returns the
        per-bucket report (empty when batching is off or no registered
        program covers the algorithm).
        """
        from vizier_tpu_torch.compute import registry as compute_registry

        problem = study_config.to_problem()
        kwargs_fn = getattr(self._policy_factory, "_gp_designer_kwargs", None)
        kwargs = kwargs_fn() if kwargs_fn is not None else {}
        report = []
        seen_factories = set()
        for program in compute_registry.programs_for_algorithm(algorithm or "DEFAULT"):
            # Programs of one designer (exact and sparse) share one walk: the
            # factory's auto-switch decides which program each bucket runs.
            factory_key = type(program.prewarm_factory(problem, **kwargs))
            if factory_key in seen_factories:
                continue
            seen_factories.add(factory_key)
            report.extend(
                self._serving.prewarm_batching(
                    problem,
                    lambda p, _program=program: _program.prewarm_factory(p, **kwargs),
                    counts=counts,
                    max_trials=max_trials,
                )
            )
        return report

    def shutdown(self) -> None:
        """Drains the serving runtime's batch executor (idempotent)."""
        self._serving.shutdown()

    def invalidate_study(self, study_name: str) -> None:
        """Drops every piece of per-study serving state (study deleted)."""
        self._serving.invalidate_study(study_name)
        self._stopping_policies.pop(study_name, None)
        self._config_cache.pop(study_name, None)
        for key in [k for k in self._policy_cache if k[0] == study_name]:
            del self._policy_cache[key]

    def _parsed_study_config(self, request) -> vz.StudyConfig:
        """The request's StudyConfig, cached by (study name, config hash).

        On a hash turnover (the same resource name with other config bytes:
        a delete/recreate through another frontend, or a metadata update,
        which can change policy construction) every per-study cache pinned
        to the previous incarnation is dropped: the parsed config, the
        policy cache, the stopping policies and, through the runtime, the
        designer-state cache and the breaker.
        """
        config_hash = _config_hash(request)
        study_name = request.study_name
        cached = self._config_cache.get(study_name)
        if cached is not None and cached[0] == config_hash:
            return cached[1]
        if cached is not None:
            self._stopping_policies.pop(study_name, None)
            for key in [k for k in self._policy_cache if k[0] == study_name]:
                del self._policy_cache[key]
        config = pc.study_config_from_proto(request.study_descriptor.config)
        if study_name:
            self._config_cache[study_name] = (config_hash, config)
            self._serving.note_study_config(study_name, config_hash)
        return config

    def _get_policy(
        self,
        study_config: vz.StudyConfig,
        algorithm: str,
        study_name: str,
        config_hash: str = "",
    ) -> policy_lib.Policy:
        supporter = service_policy_supporter.ServicePolicySupporter(study_name, self._vizier)
        # Keyed by (study, algorithm, config hash): a cached policy must
        # die with the config incarnation it was constructed from.
        key = (study_name, algorithm, config_hash)
        cached = self._policy_cache.get(key)
        if cached is not None:
            return cached
        policy = self._policy_factory(study_config.to_problem(), algorithm, supporter, study_name)
        if policy.should_be_cached:
            self._policy_cache[key] = policy
        return policy

    def Suggest(
        self, request: pythia_service_pb2.PythiaSuggestRequest, context=None
    ) -> pythia_service_pb2.PythiaSuggestResponse:
        # Trace parentage comes from the request's wire context, not the
        # ambient contextvar: the deadline-bounded dispatch runs this method
        # on a fresh worker thread, and a remote stub crosses a process.
        tracer = tracing_lib.get_tracer()
        parent = tracing_lib.parse_context(request.trace_context)
        t0 = time.perf_counter()
        with tracer.span(
            "pythia.suggest",
            parent=parent,
            study=request.study_name,
            algorithm=request.algorithm,
            count=int(request.count),
            deadline_remaining_secs=float(request.deadline_secs),
        ) as span:
            response = self._suggest_coalesced(request)
            if response.error:
                span.set_attribute("error", response.error.splitlines()[0][:200])
            trace_id = getattr(span, "trace_id", None)
        self._serving.observe_suggest_latency("pythia", time.perf_counter() - t0, trace_id=trace_id)
        return response

    def _suggest_coalesced(
        self, request: pythia_service_pb2.PythiaSuggestRequest
    ) -> pythia_service_pb2.PythiaSuggestResponse:
        """The request through ``ServingRuntime.serve_suggest``: coalescing
        (concurrent suggests against the same study state, i.e. name,
        config incarnation, algorithm, trial frontier and count, collapse
        onto one designer computation; followers receive their own copy of
        the response, since protos are mutable and cross servicer threads),
        the speculative serve check, the admission gate, then the guarded
        designer computation under the request's wire deadline."""
        key = coalescer_lib.suggest_key(
            request.study_name,
            _config_hash(request),
            request.algorithm,
            int(request.study_descriptor.max_trial_id),
            int(request.count),
        )

        def clone(resp):
            out = pythia_service_pb2.PythiaSuggestResponse()
            out.CopyFrom(resp)
            return out

        return self._serving.serve_suggest(
            request.study_name,
            max(1, int(request.count)),
            key=key,
            fingerprint=lambda: self._request_fingerprint(request),
            prepare=lambda: self._prepare_compute(request),
            fallback=lambda reason: self._fallback_suggestions(
                self._parsed_study_config(request), request, reason
            ),
            respond=self._response,
            stamp=self._stamp_speculative,
            succeeded=lambda response: not response.error,
            deadline_secs=float(request.deadline_secs),
            # A degraded serve parses the config first: a config that fails
            # to parse is a permanent error there, as on the live path.
            setup=lambda: self._parsed_study_config(request),
            clone=clone,
        )

    # -- speculative pre-compute (serving.speculative) ------------------------

    def notify_trial_event(self, study_name: str) -> None:
        """A completion or measurement moved the study's frontier: drop the
        parked batch and enqueue a pre-compute for the new frontier."""
        self._serving.notify_trial_event(study_name)

    def _trial_frontier(self, study_name: str):
        """``(completed_ids, active_ids, max_trial_id)`` via the connected
        Vizier service (copy-free when in-process)."""
        frontier = getattr(self._vizier, "trial_frontier", None)
        if frontier is not None:
            return frontier(study_name)
        listing = self._vizier.ListTrials(vizier_service_pb2.ListTrialsRequest(parent=study_name))
        completed, active, max_id = [], [], 0
        for t in listing.trials:
            max_id = max(max_id, int(t.id))
            if t.state in (study_pb2.Trial.SUCCEEDED, study_pb2.Trial.INFEASIBLE):
                completed.append(int(t.id))
            elif t.state == study_pb2.Trial.ACTIVE:
                active.append(int(t.id))
        return completed, active, max_id

    def _speculative_fingerprint(self, study_name: str):
        """Job-side frontier read: the fingerprint the parked batch will be
        served under, captured before the compute (anything landing after
        this point makes the slot a serve-time mismatch)."""
        study = self._vizier.GetStudy(vizier_service_pb2.GetStudyRequest(name=study_name))
        completed, active, max_id = self._trial_frontier(study_name)
        fingerprint = speculative_lib.make_fingerprint(
            study.study_spec.SerializeToString(), completed, active
        )
        return fingerprint, max_id

    def _request_fingerprint(self, request) -> speculative_lib.FrontierFingerprint:
        """Serve-side frontier read: the request's config and the study's
        current completed and active sets."""
        completed, active, _ = self._trial_frontier(request.study_name)
        return speculative_lib.make_fingerprint(
            request.study_descriptor.config.SerializeToString(), completed, active
        )

    def _speculative_compute(
        self, study_name: str, count: int, max_trial_id: int
    ) -> Optional[pythia_service_pb2.PythiaSuggestResponse]:
        """Runs one speculative job through the exact live suggest path
        (coalescer → policy → designer cache → batch executor), so a hit is
        the live compute run early: the same designer state mutations, the
        same draws, the same buckets (on the deferrable lane, through the
        speculative-scope thread flag the engine sets)."""
        study = self._vizier.GetStudy(vizier_service_pb2.GetStudyRequest(name=study_name))
        if study.state != study_pb2.Study.ACTIVE:
            return None
        preq = pythia_service_pb2.PythiaSuggestRequest(
            count=count, algorithm=study.study_spec.algorithm, study_name=study_name
        )
        preq.study_descriptor.config.CopyFrom(study.study_spec)
        preq.study_descriptor.guid = study_name
        preq.study_descriptor.max_trial_id = max_trial_id
        return self._suggest_coalesced(preq)

    @staticmethod
    def _speculative_accept(response: pythia_service_pb2.PythiaSuggestResponse) -> Optional[int]:
        """The runtime's vetting rule (``speculative_batch_size``) over a
        proto response: its batch size when it may be parked, else None."""
        if response is None or response.error:
            return None
        return serving_runtime_lib.speculative_batch_size(
            pc.metadata_from_key_values(s.metadata) for s in response.suggestions
        )

    @staticmethod
    def _stamp_speculative(
        response: pythia_service_pb2.PythiaSuggestResponse, count: int
    ) -> pythia_service_pb2.PythiaSuggestResponse:
        """A private copy of the parked response, reconciled to ``count``
        (the batch prefix when the client asked for fewer) and stamped
        by ``speculative.stamp_hit``, as the runtime's
        ``stamp_speculative_hit`` stamps a protobuf-free one."""
        out = pythia_service_pb2.PythiaSuggestResponse()
        out.CopyFrom(response)
        if count < len(out.suggestions):
            del out.suggestions[count:]
        stamp = vz.Metadata()
        speculative_lib.stamp_hit(stamp)
        key_values = pc.metadata_to_key_values(stamp)
        for suggestion in out.suggestions:
            suggestion.metadata.extend(key_values)
        return out

    @staticmethod
    def _fallback_suggestions(config, request, reason: str):
        return fallback_lib.suggest_fallback(
            config.to_problem(),
            max(1, int(request.count)),
            study_name=request.study_name,
            max_trial_id=int(request.study_descriptor.max_trial_id),
            reason=reason,
        )

    def _response(
        self, outcome: serving_runtime_lib.GuardedSuggestion
    ) -> pythia_service_pb2.PythiaSuggestResponse:
        response = pythia_service_pb2.PythiaSuggestResponse()
        if outcome.error is not None:
            response.error = errors_lib.format_op_error(outcome.error)
            return response
        if outcome.decision is None:
            for s in outcome.fallbacks:
                response.suggestions.add().CopyFrom(pc.trial_suggestion_to_proto(s))
            return response
        for s in outcome.decision.suggestions:
            response.suggestions.add().CopyFrom(pc.trial_suggestion_to_proto(s))
        self._append_metadata_deltas(response, outcome.decision.metadata)
        return response

    def _prepare_compute(self, request: pythia_service_pb2.PythiaSuggestRequest):
        """The request's designer computation. Config parsing and policy
        construction fail hard: an invalid search space or unknown
        algorithm is permanent, and retrying or falling back would serve a
        misconfigured study forever."""
        config = self._parsed_study_config(request)
        algorithm = request.algorithm or config.algorithm
        if algorithm != config.algorithm:
            # The cached config is shared across requests (and threads): a
            # per-request algorithm override goes on a shallow copy so it
            # never leaks into later requests for the same study.
            config = dataclasses.replace(config, algorithm=algorithm)
        policy = self._get_policy(config, algorithm, request.study_name, _config_hash(request))
        descriptor = vz.StudyDescriptor(
            config=config,
            guid=request.study_descriptor.guid,
            max_trial_id=int(request.study_descriptor.max_trial_id),
        )
        return lambda: policy.suggest(
            policy_lib.SuggestRequest(study_descriptor=descriptor, count=int(request.count))
        )

    def EarlyStop(
        self, request: pythia_service_pb2.PythiaEarlyStopRequest, context=None
    ) -> pythia_service_pb2.PythiaEarlyStopResponse:
        response = pythia_service_pb2.PythiaEarlyStopResponse()
        try:
            # Through the parse cache: EarlyStop polls ride the same (study,
            # config-hash) identity as Suggest, so a turnover also drops the
            # cached stopping policies below.
            config = self._parsed_study_config(request)
            if config.automated_stopping_config is not None:
                # Studies with a stopping spec pick their rule (median curve
                # or curve regression); otherwise the algorithm's own policy
                # decides.
                from vizier_tpu_torch.algorithms import early_stopping

                stopping = config.automated_stopping_config
                supporter = service_policy_supporter.ServicePolicySupporter(
                    request.study_name, self._vizier
                )
                if stopping.rule == "regression":
                    # Cached per study: the policy holds a trained regressor
                    # that repeated polls between completions must reuse.
                    policy = self._stopping_policies.get(request.study_name)
                    if policy is None:
                        policy = early_stopping.RegressionEarlyStopPolicy(
                            supporter=supporter, min_num_trials=stopping.min_num_trials
                        )
                        self._stopping_policies[request.study_name] = policy
                else:
                    policy = early_stopping.MedianEarlyStopPolicy(
                        supporter=supporter,
                        use_steps=stopping.use_steps,
                        min_num_trials=stopping.min_num_trials,
                    )
            else:
                policy = self._get_policy(
                    config,
                    request.algorithm or config.algorithm,
                    request.study_name,
                    _config_hash(request),
                )
            descriptor = vz.StudyDescriptor(
                config=config,
                guid=request.study_descriptor.guid,
                max_trial_id=int(request.study_descriptor.max_trial_id),
            )
            decisions = policy.early_stop(
                policy_lib.EarlyStopRequest(
                    study_descriptor=descriptor,
                    trial_ids=frozenset(int(i) for i in request.trial_ids),
                )
            )
            for d in decisions.decisions:
                dp = response.decisions.add()
                dp.id = d.id
                dp.should_stop = d.should_stop
                dp.reason = d.reason
        except Exception as e:
            _logger.warning("Pythia EarlyStop failed: %s", traceback.format_exc())
            response.error = errors_lib.format_op_error(e)
        return response

    def Ping(
        self, request: pythia_service_pb2.PingRequest, context=None
    ) -> pythia_service_pb2.PingResponse:
        return pythia_service_pb2.PingResponse()

    @staticmethod
    def _append_metadata_deltas(
        response: pythia_service_pb2.PythiaSuggestResponse, delta: vz.MetadataDelta
    ) -> None:
        if delta.on_study.namespaces():
            dp = response.metadata_deltas.add()
            dp.trial_id = 0
            dp.key_values.extend(pc.metadata_to_key_values(delta.on_study))
        for trial_id, md in delta.on_trials.items():
            if md.namespaces():
                dp = response.metadata_deltas.add()
                dp.trial_id = trial_id
                dp.key_values.extend(pc.metadata_to_key_values(md))
