"""In-RAM policy supporter: a mini service+client for tests and benchmarks.

A copy of the JAX package's ``pythia/local_policy_supporters.py``, so that the port imports nothing
of the JAX package.

trials in memory, assigns ids, applies policy decisions, and stores prior
studies for transfer learning. This is the engine under the benchmark runner
(no gRPC service needed for research loops).
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, List, Optional, Sequence

from vizier_tpu_torch.pythia import policy as policy_lib
from vizier_tpu_torch.pythia import policy_supporter
from vizier_tpu_torch.pyvizier import study as study_lib
from vizier_tpu_torch.pyvizier import study_config as sc
from vizier_tpu_torch.pyvizier import trial as trial_


class InRamPolicySupporter(policy_supporter.PolicySupporter):
    """Owns one study's trials in RAM and drives policies against them."""

    def __init__(
        self,
        study_config: sc.StudyConfig,
        *,
        study_guid: str = "local",
    ):
        self._study_config = study_config
        self._study_guid = study_guid
        self._trials: List[trial_.Trial] = []
        # Prior studies for transfer learning, guid -> (config, trials).
        self._priors: Dict[str, "InRamPolicySupporter"] = {}

    # -- properties --------------------------------------------------------

    @property
    def study_config(self) -> sc.StudyConfig:
        return self._study_config

    @property
    def study_guid(self) -> str:
        return self._study_guid

    @property
    def trials(self) -> List[trial_.Trial]:
        return list(self._trials)

    def study_descriptor(self) -> study_lib.StudyDescriptor:
        return study_lib.StudyDescriptor(
            config=self._study_config,
            guid=self._study_guid,
            max_trial_id=len(self._trials),
        )

    # -- PolicySupporter interface ----------------------------------------

    def GetStudyConfig(self, study_guid: Optional[str] = None) -> sc.StudyConfig:
        if study_guid is None or study_guid == self._study_guid:
            return self._study_config
        if study_guid in self._priors:
            return self._priors[study_guid].study_config
        raise KeyError(f"Unknown study {study_guid!r}.")

    def GetTrials(
        self,
        *,
        study_guid: Optional[str] = None,
        trial_ids: Optional[Iterable[int]] = None,
        min_trial_id: Optional[int] = None,
        max_trial_id: Optional[int] = None,
        status_matches: Optional[trial_.TrialStatus] = None,
        include_intermediate_measurements: bool = True,
    ) -> List[trial_.Trial]:
        if study_guid is not None and study_guid != self._study_guid:
            return self._priors[study_guid].GetTrials(
                trial_ids=trial_ids,
                min_trial_id=min_trial_id,
                max_trial_id=max_trial_id,
                status_matches=status_matches,
            )
        ids = frozenset(trial_ids) if trial_ids is not None else None
        out = []
        for t in self._trials:
            if ids is not None and t.id not in ids:
                continue
            if min_trial_id is not None and t.id < min_trial_id:
                continue
            if max_trial_id is not None and t.id > max_trial_id:
                continue
            if status_matches is not None and t.status != status_matches:
                continue
            out.append(t)
        return out

    def SendMetadata(self, delta: trial_.MetadataDelta) -> None:
        self._apply_metadata(delta)

    # -- service-like operations ------------------------------------------

    def AddTrials(self, trials: Sequence[trial_.Trial]) -> None:
        """Adds copies of externally-built trials, assigning fresh ids.

        Copies, so transferring a prior study's trials cannot rewrite the
        prior study's ids in place.
        """
        for t in trials:
            t = copy.deepcopy(t)
            t.id = len(self._trials) + 1
            self._trials.append(t)

    def AddSuggestions(
        self, suggestions: Sequence[trial_.TrialSuggestion]
    ) -> List[trial_.Trial]:
        """Materializes suggestions as ACTIVE trials with fresh ids."""
        new_trials = []
        for s in suggestions:
            t = s.to_trial(len(self._trials) + 1)
            self._trials.append(t)
            new_trials.append(t)
        return new_trials

    def SuggestTrials(self, policy: policy_lib.Policy, count: int) -> List[trial_.Trial]:
        """Runs one suggest round and materializes the results as trials."""
        decision = policy.suggest(
            policy_lib.SuggestRequest(study_descriptor=self.study_descriptor(), count=count)
        )
        self._apply_metadata(decision.metadata)
        return self.AddSuggestions(decision.suggestions)

    def EarlyStopTrials(
        self, policy: policy_lib.Policy, trial_ids: Iterable[int] = ()
    ) -> policy_lib.EarlyStopDecisions:
        ids = frozenset(trial_ids)
        if not ids:
            # Empty means "consider everything that could stop" (the
            # EarlyStopRequest contract): all ACTIVE and STOPPING trials.
            ids = frozenset(
                t.id
                for t in self._trials
                if t.status in (trial_.TrialStatus.ACTIVE, trial_.TrialStatus.STOPPING)
            )
        decisions = policy.early_stop(
            policy_lib.EarlyStopRequest(
                study_descriptor=self.study_descriptor(), trial_ids=ids
            )
        )
        self._apply_metadata(decisions.metadata)
        for d in decisions.decisions:
            if d.should_stop:
                for t in self._trials:
                    if t.id == d.id:
                        t.stop(d.reason)
        return decisions

    def SetPriorStudy(
        self, supporter: "InRamPolicySupporter", study_guid: Optional[str] = None
    ) -> str:
        """Registers a prior study for transfer learning; returns its guid."""
        guid = study_guid if study_guid is not None else supporter.study_guid
        self._priors[guid] = supporter
        return guid

    # -- internals ---------------------------------------------------------

    def _apply_metadata(self, delta: trial_.MetadataDelta) -> None:
        self._study_config.metadata.attach(delta.on_study)
        for tid, md in delta.on_trials.items():
            for t in self._trials:
                if t.id == tid:
                    t.metadata.attach(md)
