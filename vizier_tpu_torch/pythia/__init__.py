"""Pythia facade of the port: the algorithm-hosting protocol (own copies)."""

from vizier_tpu_torch.pythia.errors import (
    CachedPolicyIsStaleError,
    CancelComputeError,
    CancelledByVizierError,
    InactivateStudyError,
    PythiaProtocolError,
    TemporaryPythiaError,
    VizierDatabaseError,
)
from vizier_tpu_torch.pythia.local_policy_supporters import InRamPolicySupporter
from vizier_tpu_torch.pythia.policy import (
    EarlyStopDecision,
    EarlyStopDecisions,
    EarlyStopRequest,
    Policy,
    SuggestDecision,
    SuggestRequest,
)
from vizier_tpu_torch.pythia.policy_supporter import PolicySupporter

__all__ = [
    "CachedPolicyIsStaleError",
    "CancelComputeError",
    "CancelledByVizierError",
    "EarlyStopDecision",
    "EarlyStopDecisions",
    "EarlyStopRequest",
    "InRamPolicySupporter",
    "InactivateStudyError",
    "Policy",
    "PolicySupporter",
    "PythiaProtocolError",
    "SuggestDecision",
    "SuggestRequest",
    "TemporaryPythiaError",
    "VizierDatabaseError",
]
