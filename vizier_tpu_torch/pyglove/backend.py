"""PyGlove integration: evolutionary/program search on the vizier service.

Parity in role with ``vizier/_src/pyglove/``
(``backend.py:69`` ``VizierBackend(pg.tuning.Backend)``, ``pythia.py``
``TunerPolicy``, ``converters.py`` DNA⇄Trial): PyGlove drives program
search; each DNA materializes as a vizier trial, and a PyGlove
``DNAGenerator`` runs as a Pythia policy so primary/secondary tuner
processes share one study with failover.

PyGlove is an optional dependency, so everything importing ``pg`` is
gated: the module imports cleanly, constructing the backend without pyglove
raises a clear ImportError, and the serialized-DNA trial converters (plain
dict encoding) are testable standalone.

Copy of the JAX package's ``pyglove/backend.py``, on the port's data model
and Pythia policy. ``VizierBackend`` goes through ``service/clients.py``
(gRPC and protobuf), which it imports when it is constructed; the service
policy factory's PYGLOVE route serves ``TunerPolicy`` over the generator a
primary tuner registered here.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.pythia import policy as policy_lib

try:  # pragma: no cover - exercised only where pyglove is installed.
    import pyglove as pg

    PYGLOVE_AVAILABLE = True
except ImportError:  # pragma: no cover
    pg = None
    PYGLOVE_AVAILABLE = False

_DNA_KEY = "dna_spec_values"
_NS = "pyglove"

# Global registry study_name -> (dna_spec, generator). The PRIMARY tuner
# registers its generator here so the in-process policy factory can host it
# (parity with the reference's global policy cache, ``backend.py:66``).
_GENERATOR_REGISTRY: Dict[str, tuple] = {}


def register_generator(study_name: str, dna_spec, algorithm) -> None:
    _GENERATOR_REGISTRY[study_name] = (dna_spec, algorithm)


def get_registered_generator(study_name: str):
    return _GENERATOR_REGISTRY.get(study_name)


class DNATrialConverter:
    """Serialized-DNA ⇄ trial converters (pure; no pyglove required).

    DNA decision values are stored both as trial parameters (for
    observability) and as a JSON blob in metadata (for lossless recovery).
    """

    @staticmethod
    def to_suggestion(decisions: Dict[str, Any]) -> vz.TrialSuggestion:
        params = vz.ParameterDict()
        for key, value in decisions.items():
            if isinstance(value, (str, int, float, bool)):
                params[key] = value
            else:
                params[key] = json.dumps(value)
        suggestion = vz.TrialSuggestion(parameters=params)
        suggestion.metadata.ns(_NS)[_DNA_KEY] = json.dumps(decisions)
        return suggestion

    @staticmethod
    def to_decisions(trial: vz.Trial) -> Dict[str, Any]:
        raw = trial.metadata.ns(_NS).get(_DNA_KEY)
        if raw is not None:
            return json.loads(raw)
        return {k: v.value for k, v in trial.parameters.items()}


def _build_pg_dna(values) -> "pg.DNA":  # pragma: no cover - needs pyglove
    """Nested (value, children) tuples → pg.DNA tree."""

    def node(v, children):
        return pg.DNA(v, [node(*c) for c in children])

    return pg.DNA(None, [node(*c) for c in values])


class TunerPolicy(policy_lib.Policy):
    """Hosts a PyGlove DNAGenerator as a Pythia policy.

    With a structured DNASpec, trials round-trip through
    ``converters.DNASpecConverter`` (full tree: conditional candidate
    subspaces, multi-subchoices, floats); dict-DNAs keep the plain encoding.
    """

    def __init__(self, supporter, dna_spec, algorithm):
        if not PYGLOVE_AVAILABLE:
            raise ImportError("pyglove is required for TunerPolicy.")
        self._supporter = supporter
        self._dna_spec = dna_spec
        self._algorithm = algorithm  # a pg.DNAGenerator
        self._algorithm.setup(dna_spec)
        self._fed_ids: set = set()
        self._tree_converter = None
        if hasattr(dna_spec, "elements"):
            from vizier_tpu_torch.pyglove import converters as pg_converters

            self._tree_converter = pg_converters.DNASpecConverter(dna_spec)

    @property
    def should_be_cached(self) -> bool:
        return True

    def _trial_to_dna(self, t: vz.Trial) -> "pg.DNA":
        if self._tree_converter is not None:
            dna = _build_pg_dna(self._tree_converter.to_dna_values(t))
        else:
            dna = pg.DNA(DNATrialConverter.to_decisions(t))  # type: ignore[union-attr]
        dna.use_spec(self._dna_spec)
        return dna

    def _dna_to_suggestion(self, dna) -> vz.TrialSuggestion:
        if self._tree_converter is not None:
            return self._tree_converter.to_trial_suggestion(dna)
        return DNATrialConverter.to_suggestion(dna.to_dict())

    def suggest(self, request: policy_lib.SuggestRequest) -> policy_lib.SuggestDecision:
        # Feed newly-completed FEASIBLE trials back into the generator.
        completed = self._supporter.GetTrials(status_matches=vz.TrialStatus.COMPLETED)
        for t in completed:
            if t.id in self._fed_ids or t.final_measurement is None or t.infeasible:
                continue
            metrics = t.final_measurement.metrics
            metric = metrics.get("reward") or next(iter(metrics.values()))
            self._algorithm.feedback(self._trial_to_dna(t), metric.value)
            self._fed_ids.add(t.id)
        suggestions = []
        for _ in range(request.count):
            dna = self._algorithm.propose()
            suggestions.append(self._dna_to_suggestion(dna))
        return policy_lib.SuggestDecision(suggestions=suggestions)


class VizierBackend:
    """pg.tuning backend running PyGlove search over the vizier service.

    Tuner modes mirror the reference (``backend.py:46-62``): the PRIMARY
    tuner hosts the generator; SECONDARY tuners attach to the same study and
    only evaluate — if the primary dies, any secondary can be promoted by
    re-registering the generator (state is re-fed from completed trials).
    """

    def __init__(
        self,
        study_id: str,
        dna_spec=None,
        algorithm=None,
        *,
        owner: str = "pyglove",
        endpoint: Optional[str] = None,
    ):
        if not PYGLOVE_AVAILABLE:
            raise ImportError(
                "pyglove is not installed in this environment; VizierBackend "
                "requires pyglove. DNATrialConverter works standalone."
            )
        from vizier_tpu_torch.service import clients

        config = vz.StudyConfig(algorithm="PYGLOVE")
        config.metric_information.append(
            vz.MetricInformation(name="reward", goal=vz.ObjectiveMetricGoal.MAXIMIZE)
        )
        self._study = clients.Study.from_study_config(
            config, owner=owner, study_id=study_id, endpoint=endpoint
        )
        self._dna_spec = dna_spec
        self._algorithm = algorithm
        if dna_spec is not None and algorithm is not None:
            # PRIMARY tuner: host the generator for the policy factory.
            register_generator(self._study.resource_name, dna_spec, algorithm)

    def next_trial(self):
        (trial,) = self._study.suggest(count=1)
        return trial

    def study(self):
        return self._study
