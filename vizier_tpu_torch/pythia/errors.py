"""Typed Pythia error protocol.

A copy of the JAX package's ``pythia/errors.py``, so that the port imports nothing
of the JAX package.

The service maps these onto retry / study-inactivation / cache-rebuild
behaviors.
"""

from __future__ import annotations


class PythiaProtocolError(Exception):
    """A bug in the Pythia protocol implementation itself."""


class TemporaryPythiaError(Exception):
    """Transient failure; the caller should retry the request."""


class InactivateStudyError(Exception):
    """Unrecoverable for this study; the service should mark it aborted."""


class CachedPolicyIsStaleError(Exception):
    """The cached policy no longer matches the study; rebuild and retry."""


class CancelComputeError(Exception):
    """Raised inside a policy when cancellation was requested."""


class VizierDatabaseError(Exception):
    """The Vizier service failed to serve a supporter request."""


class CancelledByVizierError(Exception):
    """The Vizier service asked the policy to stop computing."""
