"""Hand-written gRPC stubs and servicer registration.

A copy of the JAX package's ``service/grpc_stubs.py``: messages are
protoc-generated (``protos/``) and the thin method tables below provide what
``*_pb2_grpc.py`` would (grpcio-tools, the service-stub generator, is not a
dependency). The services are named under the port's proto package, so the
method paths are ``/vizier_tpu_torch.VizierService/...``,
``/vizier_tpu_torch.PythiaService/...`` and
``/vizier_tpu_torch.ReplicationService/...``: the payloads are the JAX
package's byte for byte, but a JAX-package client cannot call the port's
server, nor the reverse.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

import grpc

from vizier_tpu_torch.service.protos import (
    pythia_service_pb2,
    replication_service_pb2,
    study_pb2,
    vizier_service_pb2,
)

_V = vizier_service_pb2
_P = pythia_service_pb2
_R = replication_service_pb2

# method name -> (request class, response class)
VIZIER_METHODS: Dict[str, Tuple[Any, Any]] = {
    "CreateStudy": (_V.CreateStudyRequest, study_pb2.Study),
    "GetStudy": (_V.GetStudyRequest, study_pb2.Study),
    "ListStudies": (_V.ListStudiesRequest, _V.ListStudiesResponse),
    "DeleteStudy": (_V.DeleteStudyRequest, _V.Empty),
    "SetStudyState": (_V.SetStudyStateRequest, study_pb2.Study),
    "SuggestTrials": (_V.SuggestTrialsRequest, _V.Operation),
    "GetOperation": (_V.GetOperationRequest, _V.Operation),
    "CreateTrial": (_V.CreateTrialRequest, study_pb2.Trial),
    "GetTrial": (_V.GetTrialRequest, study_pb2.Trial),
    "ListTrials": (_V.ListTrialsRequest, _V.ListTrialsResponse),
    "AddTrialMeasurement": (_V.AddTrialMeasurementRequest, study_pb2.Trial),
    "CompleteTrial": (_V.CompleteTrialRequest, study_pb2.Trial),
    "DeleteTrial": (_V.DeleteTrialRequest, _V.Empty),
    "CheckTrialEarlyStoppingState": (
        _V.CheckTrialEarlyStoppingStateRequest,
        _V.CheckTrialEarlyStoppingStateResponse,
    ),
    "StopTrial": (_V.StopTrialRequest, study_pb2.Trial),
    "ListOptimalTrials": (_V.ListOptimalTrialsRequest, _V.ListOptimalTrialsResponse),
    "UpdateMetadata": (_V.UpdateMetadataRequest, _V.UpdateMetadataResponse),
}

PYTHIA_METHODS: Dict[str, Tuple[Any, Any]] = {
    "Suggest": (_P.PythiaSuggestRequest, _P.PythiaSuggestResponse),
    "EarlyStop": (_P.PythiaEarlyStopRequest, _P.PythiaEarlyStopResponse),
    "Ping": (_P.PingRequest, _P.PingResponse),
}

# The cross-process replication plane (standby-log streaming, lease
# heartbeats, recovery plumbing — vizier_tpu_torch.distributed).
REPLICATION_METHODS: Dict[str, Tuple[Any, Any]] = {
    "DeliverAppends": (_R.DeliverAppendsRequest, _R.DeliverAppendsResponse),
    "Baseline": (_R.DeliverAppendsRequest, _R.DeliverAppendsResponse),
    "Fence": (_R.FenceRequest, _R.FenceResponse),
    "Heartbeat": (_R.HeartbeatRequest, _R.HeartbeatResponse),
    "ExportStandby": (_R.ExportStandbyRequest, _R.ExportStandbyResponse),
    "ExportState": (_R.ExportStateRequest, _R.ExportStateResponse),
    "ApplyRecords": (_R.ApplyRecordsRequest, _R.ApplyRecordsResponse),
    "Resync": (_R.ResyncRequest, _R.ResyncResponse),
    "FlushStream": (_R.FlushStreamRequest, _R.FlushStreamResponse),
}

VIZIER_SERVICE_NAME = "vizier_tpu_torch.VizierService"
PYTHIA_SERVICE_NAME = "vizier_tpu_torch.PythiaService"
REPLICATION_SERVICE_NAME = "vizier_tpu_torch.ReplicationService"


def _wrap(servicer, method_name: str):
    fn = getattr(servicer, method_name)

    def handler(request, context):
        try:
            return fn(request, context)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    return handler


def _add_servicer(servicer, server, service_name: str, methods: Dict[str, Tuple[Any, Any]]):
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            _wrap(servicer, name),
            request_deserializer=req_cls.FromString,
            response_serializer=lambda msg: msg.SerializeToString(),
        )
        for name, (req_cls, _) in methods.items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service_name, handlers),)
    )


def add_vizier_servicer_to_server(servicer, server) -> None:
    _add_servicer(servicer, server, VIZIER_SERVICE_NAME, VIZIER_METHODS)


def add_pythia_servicer_to_server(servicer, server) -> None:
    _add_servicer(servicer, server, PYTHIA_SERVICE_NAME, PYTHIA_METHODS)


def add_replication_servicer_to_server(servicer, server) -> None:
    _add_servicer(servicer, server, REPLICATION_SERVICE_NAME, REPLICATION_METHODS)


class _Stub:
    """Callable-per-method stub: ``stub.GetStudy(request) -> Study``.

    Status codes are translated back into the exceptions the in-process
    servicer raises (NOT_FOUND → datastore NotFoundError, INVALID_ARGUMENT →
    ValueError), so the network and in-process transports are
    indistinguishable to callers — the substitutability contract the client
    conformance suite checks on both.
    """

    def __init__(self, channel: grpc.Channel, service_name: str, methods):
        from vizier_tpu_torch.service import datastore as datastore_lib

        def bind(callable_):
            def call(request):
                try:
                    return callable_(request)
                except grpc.RpcError as e:  # pragma: no branch
                    code = e.code() if hasattr(e, "code") else None
                    if code == grpc.StatusCode.NOT_FOUND:
                        raise datastore_lib.NotFoundError(e.details()) from e
                    if code == grpc.StatusCode.INVALID_ARGUMENT:
                        raise ValueError(e.details()) from e
                    raise

            return call

        for name, (req_cls, resp_cls) in methods.items():
            setattr(
                self,
                name,
                bind(
                    channel.unary_unary(
                        f"/{service_name}/{name}",
                        request_serializer=req_cls.SerializeToString,
                        response_deserializer=resp_cls.FromString,
                    )
                ),
            )


class VizierServiceStub(_Stub):
    def __init__(self, channel: grpc.Channel):
        super().__init__(channel, VIZIER_SERVICE_NAME, VIZIER_METHODS)


class PythiaServiceStub(_Stub):
    def __init__(self, channel: grpc.Channel):
        super().__init__(channel, PYTHIA_SERVICE_NAME, PYTHIA_METHODS)


class ReplicationServiceStub(_Stub):
    def __init__(self, channel: grpc.Channel):
        super().__init__(channel, REPLICATION_SERVICE_NAME, REPLICATION_METHODS)


# One channel per endpoint for the process lifetime. Stub creation sits on
# every client constructor (`vizier_client.create_or_load_study`), and a
# fresh `grpc.insecure_channel` per call leaks its sockets + watcher
# threads for the life of the process — enough accumulated channels
# eventually wedge grpc-core's connectivity subscription (observed as a
# hang inside `channel.subscribe` after ~900 tests). gRPC channels are
# thread-safe and auto-reconnect, so sharing per endpoint is the intended
# usage.
#
# The ready-wait runs ONLY on first creation (every channel_ready_future
# subscribes a connectivity-watcher thread; re-subscribing per stub churns
# threads and races channel.close() at server stop). Concurrent callers
# share the creator's outcome via the entry's event, and a failed
# ready-wait evicts the entry so retries re-attempt readiness instead of
# receiving a never-connected channel.
_CHANNEL_LOCK = threading.Lock()


class _ChannelEntry:
    def __init__(self, channel: grpc.Channel):
        self.channel = channel
        self.ready = threading.Event()
        self.error: Any = None
        # Liveness flag kept fresh by one connectivity watcher per CHANNEL
        # (not per stub call, so no thread churn): a server that dies
        # without close_channel() flips it, and the next cache hit evicts
        # and reconnects instead of handing back a dead channel whose
        # failure would only surface at first RPC.
        self.broken = False
        channel.subscribe(self._watch, try_to_connect=False)

    def _watch(self, state: grpc.ChannelConnectivity) -> None:
        # ONLY SHUTDOWN marks a channel broken. TRANSIENT_FAILURE is a
        # normal intermediate state (a failed connect attempt during a
        # server restart, before gRPC's auto-reconnect succeeds); treating
        # it as broken made a _shared_channel call racing a brief outage
        # evict-and-close() the channel underneath every stub already
        # sharing it — permanently killing stubs gRPC would have recovered.
        if state is grpc.ChannelConnectivity.SHUTDOWN:
            self.broken = True


_CHANNELS: Dict[str, _ChannelEntry] = {}


def _shared_channel(endpoint: str, timeout: float) -> grpc.Channel:
    # Lock order: _CHANNEL_LOCK is a LEAF lock — only dict bookkeeping runs
    # under it. channel.close() re-enters grpc-core (connectivity watchers,
    # completion queues) and is deferred to after release.
    stale = None
    with _CHANNEL_LOCK:
        entry = _CHANNELS.get(endpoint)
        if entry is not None and entry.broken and entry.ready.is_set():
            # Stale cache hit: evict, close (outside the lock), fall
            # through to a fresh connect (which re-runs the ready-wait).
            del _CHANNELS[endpoint]
            stale = entry
            entry = None
        fresh = entry is None
        if fresh:
            entry = _ChannelEntry(grpc.insecure_channel(endpoint))
            _CHANNELS[endpoint] = entry
    if stale is not None:
        stale.channel.close()
    if fresh:
        try:
            grpc.channel_ready_future(entry.channel).result(timeout=timeout)
        except Exception as e:  # timeout or connectivity failure
            entry.error = e
            with _CHANNEL_LOCK:
                if _CHANNELS.get(endpoint) is entry:
                    del _CHANNELS[endpoint]
            entry.ready.set()  # release concurrent waiters with the error
            entry.channel.close()
            raise
        entry.ready.set()
        return entry.channel
    # Cached: wait for the creator's ready outcome (usually already set).
    if not entry.ready.wait(timeout=timeout):
        raise grpc.FutureTimeoutError(
            f"Channel to {endpoint} not ready within {timeout}s."
        )
    if entry.error is not None:
        raise entry.error
    return entry.channel


def close_channel(endpoint: str) -> None:
    """Closes and evicts the shared channel for ``endpoint`` (if any).

    Servers call this from ``stop()`` so channels to dead endpoints do not
    accumulate for the process lifetime (each test-scoped server would
    otherwise leave one live channel behind forever).
    """
    with _CHANNEL_LOCK:
        entry = _CHANNELS.pop(endpoint, None)
    if entry is not None:
        entry.channel.close()


def create_vizier_stub(endpoint: str, timeout: float = 10.0) -> VizierServiceStub:
    """Creates a stub on the shared per-endpoint channel once it is ready."""
    return VizierServiceStub(_shared_channel(endpoint, timeout))


def create_pythia_stub(endpoint: str, timeout: float = 10.0) -> PythiaServiceStub:
    return PythiaServiceStub(_shared_channel(endpoint, timeout))


def create_replication_stub(
    endpoint: str, timeout: float = 10.0
) -> ReplicationServiceStub:
    """Replication-surface stub on the shared per-endpoint channel."""
    return ReplicationServiceStub(_shared_channel(endpoint, timeout))
