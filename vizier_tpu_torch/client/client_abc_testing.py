"""Client-ABC conformance suite.

A copy of the JAX package's ``client/client_abc_testing.py``: a
behavioral test mixin any ``StudyInterface`` implementation (this OSS
service, a cloud client, an in-RAM fake) must pass. Subclasses implement
``create_study(problem, study_id)``.
"""

from __future__ import annotations

import abc
from typing import TypeVar

from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.client import client_abc

_S = TypeVar("_S", bound=client_abc.StudyInterface)


class StudyConformance(abc.ABC):
    """Mixin of behavioral tests over the StudyInterface contract."""

    @abc.abstractmethod
    def create_study(self, problem: vz.ProblemStatement, study_id: str) -> _S:
        ...

    def _problem(self) -> vz.ProblemStatement:
        problem = vz.ProblemStatement()
        problem.search_space.root.add_float_param("x", 0.0, 1.0)
        problem.search_space.root.add_categorical_param("c", ["a", "b"])
        problem.metric_information.append(
            vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE)
        )
        return problem

    # -- suggest / complete --------------------------------------------------

    def test_suggest_returns_count(self):
        study = self.create_study(self._problem(), "conf-suggest")
        trials = study.suggest(count=3)
        assert len(trials) == 3
        assert all(t.status == vz.TrialStatus.ACTIVE for t in trials)

    def test_complete_and_materialize(self):
        study = self.create_study(self._problem(), "conf-complete")
        (trial,) = study.suggest(count=1)
        final = trial.complete(vz.Measurement(metrics={"obj": 0.7}))
        assert final.metrics["obj"].value == 0.7
        materialized = trial.materialize()
        assert materialized.status == vz.TrialStatus.COMPLETED

    def test_parameters_external_types(self):
        study = self.create_study(self._problem(), "conf-params")
        (trial,) = study.suggest(count=1)
        params = trial.parameters
        assert isinstance(params["x"], float)
        assert params["c"] in ("a", "b")

    def test_infeasible_completion(self):
        study = self.create_study(self._problem(), "conf-infeasible")
        (trial,) = study.suggest(count=1)
        trial.complete(infeasible_reason="broke")
        assert trial.materialize().infeasible

    def test_intermediate_measurements(self):
        study = self.create_study(self._problem(), "conf-measure")
        (trial,) = study.suggest(count=1)
        trial.add_measurement(vz.Measurement(metrics={"obj": 0.1}, steps=1))
        trial.add_measurement(vz.Measurement(metrics={"obj": 0.2}, steps=2))
        assert len(trial.materialize().measurements) == 2

    # -- listing / filtering -------------------------------------------------

    def test_trials_listing_and_filter(self):
        study = self.create_study(self._problem(), "conf-list")
        a, b = study.suggest(count=2)
        a.complete(vz.Measurement(metrics={"obj": 1.0}))
        completed = list(study.trials(vz.TrialFilter(status=[vz.TrialStatus.COMPLETED])))
        assert [t.id for t in completed] == [a.id]
        assert len(list(study.trials())) == 2

    def test_get_trial_and_missing(self):
        study = self.create_study(self._problem(), "conf-get")
        (trial,) = study.suggest(count=1)
        assert study.get_trial(trial.id).id == trial.id
        try:
            study.get_trial(424242)
        except client_abc.ResourceNotFoundError:
            pass
        else:  # pragma: no cover
            raise AssertionError("Expected ResourceNotFoundError.")

    def test_optimal_trials(self):
        study = self.create_study(self._problem(), "conf-optimal")
        values = [0.2, 0.9, 0.5]
        for trial, v in zip(study.suggest(count=3), values):
            trial.complete(vz.Measurement(metrics={"obj": v}))
        (best,) = study.optimal_trials()
        assert best.materialize().final_measurement.metrics["obj"].value == 0.9

    # -- study-level ----------------------------------------------------------

    def test_materialize_study_config(self):
        study = self.create_study(self._problem(), "conf-config")
        config = study.materialize_study_config()
        assert set(config.search_space.parameter_names()) == {"x", "c"}

    def test_metadata_roundtrip(self):
        study = self.create_study(self._problem(), "conf-md")
        md = vz.Metadata()
        md.ns("user")["note"] = "hello"
        study.update_metadata(md)
        assert study.materialize_study_config().metadata.ns("user")["note"] == "hello"

    def test_delete_trial(self):
        study = self.create_study(self._problem(), "conf-del")
        a, b = study.suggest(count=2)
        a.delete()
        assert [t.id for t in study.trials()] == [b.id]

    # -- worker semantics --------------------------------------------------

    def test_suggest_same_worker_reuses_active_trials(self):
        """A crashed worker re-requesting suggestions gets its trials back."""
        study = self.create_study(self._problem(), "conf-worker-same")
        first = study.suggest(count=2, client_id="w1")
        again = study.suggest(count=2, client_id="w1")
        assert sorted(t.id for t in first) == sorted(t.id for t in again)

    def test_suggest_different_workers_get_distinct_trials(self):
        study = self.create_study(self._problem(), "conf-worker-diff")
        a = study.suggest(count=2, client_id="w1")
        b = study.suggest(count=2, client_id="w2")
        assert not set(t.id for t in a) & set(t.id for t in b)

    def test_completed_worker_gets_fresh_trials(self):
        study = self.create_study(self._problem(), "conf-worker-fresh")
        (t1,) = study.suggest(count=1, client_id="w1")
        t1.complete(vz.Measurement(metrics={"obj": 0.5}))
        (t2,) = study.suggest(count=1, client_id="w1")
        assert t2.id != t1.id

    # -- completion semantics ------------------------------------------------

    def test_complete_no_measurements_is_infeasible(self):
        study = self.create_study(self._problem(), "conf-complete-empty")
        (trial,) = study.suggest(count=1)
        trial.complete()
        assert trial.materialize().infeasible

    def test_complete_auto_selects_last_measurement(self):
        study = self.create_study(self._problem(), "conf-complete-auto")
        (trial,) = study.suggest(count=1)
        trial.add_measurement(vz.Measurement(metrics={"obj": 0.1}, steps=1))
        trial.add_measurement(vz.Measurement(metrics={"obj": 0.8}, steps=2))
        trial.complete()
        final = trial.materialize().final_measurement
        assert final.metrics["obj"].value == 0.8

    def test_measurement_after_completion_fails(self):
        study = self.create_study(self._problem(), "conf-complete-immutable")
        (trial,) = study.suggest(count=1)
        trial.complete(vz.Measurement(metrics={"obj": 0.4}))
        try:
            trial.add_measurement(vz.Measurement(metrics={"obj": 0.5}))
        except Exception:
            pass
        else:  # pragma: no cover
            raise AssertionError("Completed trials must be immutable.")

    def test_double_complete_fails(self):
        study = self.create_study(self._problem(), "conf-complete-twice")
        (trial,) = study.suggest(count=1)
        trial.complete(vz.Measurement(metrics={"obj": 0.4}))
        try:
            trial.complete(vz.Measurement(metrics={"obj": 0.9}))
        except Exception:
            pass
        else:  # pragma: no cover
            raise AssertionError("Second complete() must fail.")

    # -- early stopping ------------------------------------------------------

    def test_stop_trial(self):
        study = self.create_study(self._problem(), "conf-stop")
        (trial,) = study.suggest(count=1)
        trial.stop()
        assert trial.materialize().status == vz.TrialStatus.STOPPING

    def test_check_early_stopping_returns_bool(self):
        study = self.create_study(self._problem(), "conf-earlystop")
        (trial,) = study.suggest(count=1)
        assert isinstance(trial.check_early_stopping(), bool)

    # -- study lifecycle -----------------------------------------------------

    def test_optimal_trials_on_empty_study(self):
        study = self.create_study(self._problem(), "conf-optimal-empty")
        assert len(list(study.optimal_trials())) == 0

    def test_trials_iter_and_get_are_equal(self):
        study = self.create_study(self._problem(), "conf-iter-get")
        study.suggest(count=3)
        for listed in study.trials():
            direct = study.get_trial(listed.id)
            assert direct.id == listed.id
            assert direct.parameters == listed.parameters

    def test_set_state_aborts_study(self):
        study = self.create_study(self._problem(), "conf-state")
        study.set_state(vz.StudyState.ABORTED)
        config_or_state = study.materialize_state()
        assert config_or_state == vz.StudyState.ABORTED

    def test_delete_study(self):
        study = self.create_study(self._problem(), "conf-delete-study")
        study.suggest(count=1)
        study.delete()
        try:
            study.get_trial(1)
        except Exception:
            pass
        else:  # pragma: no cover
            raise AssertionError("Deleted study must not serve trials.")

    def test_trial_update_metadata(self):
        study = self.create_study(self._problem(), "conf-trial-md")
        (trial,) = study.suggest(count=1)
        md = vz.Metadata()
        md.ns("worker")["note"] = "t1"
        trial.update_metadata(md)
        assert trial.materialize().metadata.ns("worker")["note"] == "t1"
