"""Server bootstrap: single-process and split-Pythia topologies.

A copy of the JAX package's ``service/vizier_server.py``. ``device`` is
where the Pythia servicer's designers run: CUDA unless the caller asks for
the CPU; without a GPU and without ``device="cpu"`` the server raises before
it binds a port.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc

from vizier_tpu_torch import device as device_lib


def _pick_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class DefaultVizierServer:
    """Vizier + Pythia servicers in one process behind one gRPC server."""

    def __init__(
        self,
        host: str = "localhost",
        database_url: Optional[str] = None,
        policy_factory=None,
        port: Optional[int] = None,
        serving_config=None,
        datastore=None,
        *,
        device: device_lib.DeviceLike = "cuda",
    ):
        from vizier_tpu_torch.service import grpc_stubs
        from vizier_tpu_torch.service import pythia_service
        from vizier_tpu_torch.service import vizier_service

        self.device = device_lib.resolve(device)
        self._port = port or _pick_port()
        # ``datastore`` injects a storage backend; mutually exclusive with
        # database_url.
        self._servicer = vizier_service.VizierServicer(
            database_url=database_url, datastore=datastore
        )
        # ``serving_config`` (vizier_tpu_torch.serving.ServingConfig) tunes or
        # disables the stateful serving runtime — designer cache, warm ARD
        # starts, request coalescing. None -> defaults + env overrides
        # (VIZIER_TORCH_SERVING_CACHE / _WARM_START / _COALESCING = 0);
        # ServingConfig.disabled() gives stateless cold-train-per-request
        # serving.
        self._pythia_servicer = pythia_service.PythiaServicer(
            self._servicer, policy_factory, serving_config=serving_config, device=self.device
        )
        self._servicer.set_pythia(self._pythia_servicer)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=30))
        grpc_stubs.add_vizier_servicer_to_server(self._servicer, self._server)
        grpc_stubs.add_pythia_servicer_to_server(self._pythia_servicer, self._server)
        self._endpoint = f"{host}:{self._port}"
        self._server.add_insecure_port(self._endpoint)
        self._server.start()

    @property
    def endpoint(self) -> str:
        return self._endpoint

    @property
    def servicer(self):
        """The in-process servicer (for no-network clients)."""
        return self._servicer

    @property
    def pythia_servicer(self):
        return self._pythia_servicer

    def serving_stats(self) -> dict:
        """Serving counters: cache hits/misses, warm/cold trains, coalescing."""
        return self._pythia_servicer.serving_stats()

    def stop(self, grace: Optional[float] = None) -> None:
        # grpc.Server.stop is non-blocking (returns an event); wait for the
        # grace window to drain in-flight RPCs BEFORE closing the shared
        # client channel, else the close cancels the very RPCs the grace
        # period protects. Stubs created before stop() are invalidated. The
        # serving runtime's executor thread stops last.
        self._server.stop(grace).wait()
        from vizier_tpu_torch.service import grpc_stubs

        grpc_stubs.close_channel(self._endpoint)
        self._pythia_servicer.shutdown()

    def __del__(self):
        try:
            # grace=0, NOT None: grace=None blocks until every in-flight RPC
            # completes, which deadlocks interpreter shutdown if a handler
            # thread is still parked.
            self._server.stop(0)
            from vizier_tpu_torch.service import grpc_stubs

            grpc_stubs.close_channel(self._endpoint)
        except Exception:
            pass


class DistributedPythiaVizierServer:
    """Separate gRPC servers for Vizier and Pythia, cross-connected.

    Pythia runs max_workers=1: one policy computation at a time (one
    accelerator-bound computation per host).
    """

    def __init__(
        self,
        host: str = "localhost",
        database_url: Optional[str] = None,
        policy_factory=None,
        serving_config=None,
        *,
        device: device_lib.DeviceLike = "cuda",
    ):
        from vizier_tpu_torch.service import grpc_stubs
        from vizier_tpu_torch.service import pythia_service
        from vizier_tpu_torch.service import vizier_service

        self.device = device_lib.resolve(device)
        # Vizier server.
        self._servicer = vizier_service.VizierServicer(database_url=database_url)
        self._vizier_server = grpc.server(futures.ThreadPoolExecutor(max_workers=30))
        grpc_stubs.add_vizier_servicer_to_server(self._servicer, self._vizier_server)
        self._vizier_endpoint = f"{host}:{_pick_port()}"
        self._vizier_server.add_insecure_port(self._vizier_endpoint)
        self._vizier_server.start()

        # Pythia server (reads trials back through the Vizier stub). Note
        # DeleteStudy invalidation cannot reach a remote Pythia's designer
        # cache (no invalidation RPC); its TTL and the config-hash turnover
        # bound staleness there.
        vizier_stub = grpc_stubs.create_vizier_stub(self._vizier_endpoint)
        self._pythia_servicer = pythia_service.PythiaServicer(
            vizier_stub, policy_factory, serving_config=serving_config, device=self.device
        )
        self._pythia_server = grpc.server(futures.ThreadPoolExecutor(max_workers=1))
        grpc_stubs.add_pythia_servicer_to_server(self._pythia_servicer, self._pythia_server)
        self._pythia_endpoint = f"{host}:{_pick_port()}"
        self._pythia_server.add_insecure_port(self._pythia_endpoint)
        self._pythia_server.start()

        # Vizier dispatches suggestion work to Pythia over gRPC.
        self._servicer.set_pythia(grpc_stubs.create_pythia_stub(self._pythia_endpoint))

    @property
    def endpoint(self) -> str:
        return self._vizier_endpoint

    @property
    def pythia_endpoint(self) -> str:
        return self._pythia_endpoint

    def stop(self, grace: Optional[float] = None) -> None:
        # Drain both servers through the grace window first (stop() is
        # non-blocking), THEN close the cross-connect channels.
        pythia_done = self._pythia_server.stop(grace)
        vizier_done = self._vizier_server.stop(grace)
        pythia_done.wait()
        vizier_done.wait()
        from vizier_tpu_torch.service import grpc_stubs

        grpc_stubs.close_channel(self._pythia_endpoint)
        grpc_stubs.close_channel(self._vizier_endpoint)
        self._pythia_servicer.shutdown()
