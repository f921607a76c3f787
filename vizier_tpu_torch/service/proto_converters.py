"""PyVizier ⇄ protobuf converters.

A copy of the JAX package's ``service/proto_converters.py``, written against
the port's wire schema (``vizier_tpu_torch/service/protos``), whose messages
equal the JAX package's field for field: the same study config or trial
gives the same bytes in both packages.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional

from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.service.protos import key_value_pb2, study_pb2

# ---------------------------------------------------------------------------
# Parameter values
# ---------------------------------------------------------------------------


def parameter_value_to_proto(value: vz.ParameterValueTypes) -> study_pb2.ParameterValue:
    proto = study_pb2.ParameterValue()
    if isinstance(value, bool):
        proto.bool_value = value
    elif isinstance(value, int):
        proto.int_value = value
    elif isinstance(value, float):
        proto.double_value = value
    else:
        proto.string_value = str(value)
    return proto


def parameter_value_from_proto(proto: study_pb2.ParameterValue) -> vz.ParameterValueTypes:
    which = proto.WhichOneof("value")
    if which == "double_value":
        return proto.double_value
    if which == "int_value":
        return int(proto.int_value)
    if which == "bool_value":
        return proto.bool_value
    return proto.string_value


# ---------------------------------------------------------------------------
# Parameter configs / search space
# ---------------------------------------------------------------------------

_SCALE_TO_PROTO = {
    None: study_pb2.ParameterSpec.SCALE_UNSPECIFIED,
    vz.ScaleType.LINEAR: study_pb2.ParameterSpec.LINEAR,
    vz.ScaleType.LOG: study_pb2.ParameterSpec.LOG,
    vz.ScaleType.REVERSE_LOG: study_pb2.ParameterSpec.REVERSE_LOG,
    vz.ScaleType.UNIFORM_DISCRETE: study_pb2.ParameterSpec.UNIFORM_DISCRETE,
}
_SCALE_FROM_PROTO = {v: k for k, v in _SCALE_TO_PROTO.items()}

_EXTERNAL_TO_PROTO = {
    vz.ExternalType.INTERNAL: study_pb2.ParameterSpec.INTERNAL,
    vz.ExternalType.BOOLEAN: study_pb2.ParameterSpec.BOOLEAN,
    vz.ExternalType.INTEGER: study_pb2.ParameterSpec.INTEGER,
    vz.ExternalType.FLOAT: study_pb2.ParameterSpec.FLOAT,
}
_EXTERNAL_FROM_PROTO = {v: k for k, v in _EXTERNAL_TO_PROTO.items()}


def parameter_config_to_proto(config: vz.ParameterConfig) -> study_pb2.ParameterSpec:
    proto = study_pb2.ParameterSpec(name=config.name)
    proto.scale_type = _SCALE_TO_PROTO[config.scale_type]
    proto.external_type = _EXTERNAL_TO_PROTO[config.external_type]
    if config.type == vz.ParameterType.DOUBLE:
        lo, hi = config.bounds
        proto.double_range.min_value = lo
        proto.double_range.max_value = hi
    elif config.type == vz.ParameterType.INTEGER:
        lo, hi = config.bounds
        proto.integer_range.min_value = int(lo)
        proto.integer_range.max_value = int(hi)
    elif config.type == vz.ParameterType.DISCRETE:
        proto.discrete_values.values.extend(float(v) for v in config.feasible_values)
    elif config.type == vz.ParameterType.CATEGORICAL:
        proto.categorical_values.values.extend(str(v) for v in config.feasible_values)
    else:
        raise ValueError(f"Cannot serialize parameter type {config.type}.")
    if config.default_value is not None:
        proto.default_value.CopyFrom(parameter_value_to_proto(config.default_value))
    for child in config.children:
        child_proto = proto.children.add()
        child_proto.spec.CopyFrom(parameter_config_to_proto(child))
        for pv in child.matching_parent_values:
            child_proto.matching_parent_values.append(parameter_value_to_proto(pv))
    return proto


def parameter_config_from_proto(proto: study_pb2.ParameterSpec) -> vz.ParameterConfig:
    which = proto.WhichOneof("domain")
    kwargs = {}
    if which == "double_range":
        kwargs["bounds"] = (proto.double_range.min_value, proto.double_range.max_value)
    elif which == "integer_range":
        kwargs["bounds"] = (
            int(proto.integer_range.min_value),
            int(proto.integer_range.max_value),
        )
    elif which == "discrete_values":
        kwargs["feasible_values"] = list(proto.discrete_values.values)
    elif which == "categorical_values":
        kwargs["feasible_values"] = list(proto.categorical_values.values)
    else:
        raise ValueError(f"ParameterSpec {proto.name!r} has no domain.")
    default = None
    if proto.HasField("default_value"):
        default = parameter_value_from_proto(proto.default_value)
    children = [
        (
            [parameter_value_from_proto(pv) for pv in child.matching_parent_values],
            parameter_config_from_proto(child.spec),
        )
        for child in proto.children
    ]
    return vz.ParameterConfig.factory(
        proto.name,
        scale_type=_SCALE_FROM_PROTO.get(proto.scale_type),
        default_value=default,
        external_type=_EXTERNAL_FROM_PROTO.get(proto.external_type, vz.ExternalType.INTERNAL),
        children=children,
        **kwargs,
    )


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def metric_information_to_proto(info: vz.MetricInformation) -> study_pb2.MetricSpec:
    proto = study_pb2.MetricSpec(name=info.name)
    proto.goal = (
        study_pb2.MetricSpec.MAXIMIZE if info.goal.is_maximize else study_pb2.MetricSpec.MINIMIZE
    )
    if info.safety_threshold is not None:
        proto.safety_config.safety_threshold = info.safety_threshold
        if info.desired_min_safe_trials_fraction is not None:
            proto.safety_config.desired_min_safe_trials_fraction = (
                info.desired_min_safe_trials_fraction
            )
    import math

    if math.isfinite(info.min_value):
        proto.min_value = info.min_value
    if math.isfinite(info.max_value):
        proto.max_value = info.max_value
    return proto


def metric_information_from_proto(proto: study_pb2.MetricSpec) -> vz.MetricInformation:
    import math

    goal = (
        vz.ObjectiveMetricGoal.MAXIMIZE
        if proto.goal != study_pb2.MetricSpec.MINIMIZE
        else vz.ObjectiveMetricGoal.MINIMIZE
    )
    safety_threshold = None
    frac = None
    if proto.HasField("safety_config"):
        safety_threshold = proto.safety_config.safety_threshold
        if proto.safety_config.HasField("desired_min_safe_trials_fraction"):
            frac = proto.safety_config.desired_min_safe_trials_fraction
    return vz.MetricInformation(
        name=proto.name,
        goal=goal,
        safety_threshold=safety_threshold,
        desired_min_safe_trials_fraction=frac,
        min_value=proto.min_value if proto.HasField("min_value") else -math.inf,
        max_value=proto.max_value if proto.HasField("max_value") else math.inf,
    )


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------


def metadata_to_key_values(metadata: vz.Metadata) -> List[key_value_pb2.KeyValue]:
    out = []
    for ns, key, value in metadata.all_items():
        kv = key_value_pb2.KeyValue(key=key, ns=ns.encode())
        if isinstance(value, str):
            kv.string_value = value
        elif isinstance(value, bytes):
            kv.bytes_value = value
        elif isinstance(value, (int, float)):
            kv.double_value = float(value)
        elif hasattr(value, "SerializeToString"):
            kv.bytes_value = value.SerializeToString()
        else:
            kv.string_value = str(value)
        out.append(kv)
    return out


def metadata_from_key_values(key_values: Iterable[key_value_pb2.KeyValue]) -> vz.Metadata:
    md = vz.Metadata()
    for kv in key_values:
        ns = vz.Namespace.decode(kv.ns)
        which = kv.WhichOneof("value")
        if which == "double_value":
            value = kv.double_value
        elif which == "bytes_value":
            value = kv.bytes_value
        else:
            value = kv.string_value
        md.abs_ns(ns)[kv.key] = value
    return md


# ---------------------------------------------------------------------------
# Measurements / trials
# ---------------------------------------------------------------------------


def measurement_to_proto(m: vz.Measurement) -> study_pb2.Measurement:
    proto = study_pb2.Measurement(elapsed_secs=m.elapsed_secs, steps=m.steps)
    for name, metric in m.metrics.items():
        mp = proto.metrics.add()
        mp.name = name
        mp.value = metric.value
        if metric.std is not None:
            mp.std = metric.std
    return proto


def measurement_from_proto(proto: study_pb2.Measurement) -> vz.Measurement:
    return vz.Measurement(
        metrics={
            mp.name: vz.Metric(mp.value, std=mp.std if mp.HasField("std") else None)
            for mp in proto.metrics
        },
        elapsed_secs=proto.elapsed_secs,
        steps=proto.steps,
    )


def trial_to_proto(trial: vz.Trial, name: str = "") -> study_pb2.Trial:
    proto = study_pb2.Trial(name=name, id=trial.id)
    status = trial.status
    if status == vz.TrialStatus.REQUESTED:
        proto.state = study_pb2.Trial.REQUESTED
    elif status == vz.TrialStatus.STOPPING:
        proto.state = study_pb2.Trial.STOPPING
    elif status == vz.TrialStatus.COMPLETED:
        proto.state = (
            study_pb2.Trial.INFEASIBLE if trial.infeasible else study_pb2.Trial.SUCCEEDED
        )
    else:
        proto.state = study_pb2.Trial.ACTIVE
    for pname, pvalue in trial.parameters.items():
        assignment = proto.parameters.add()
        assignment.name = pname
        assignment.value.CopyFrom(parameter_value_to_proto(pvalue.value))
    for m in trial.measurements:
        proto.measurements.add().CopyFrom(measurement_to_proto(m))
    if trial.final_measurement is not None:
        proto.final_measurement.CopyFrom(measurement_to_proto(trial.final_measurement))
    if trial.infeasibility_reason:
        proto.infeasibility_reason = trial.infeasibility_reason
    if trial.assigned_worker:
        proto.assigned_worker = trial.assigned_worker
    if trial.stopping_reason:
        proto.stopping_reason = trial.stopping_reason
    proto.metadata.extend(metadata_to_key_values(trial.metadata))
    if trial.creation_time is not None:
        proto.creation_time_secs = trial.creation_time.timestamp()
    if trial.completion_time is not None:
        proto.completion_time_secs = trial.completion_time.timestamp()
    return proto


def trial_from_proto(proto: study_pb2.Trial) -> vz.Trial:
    import datetime

    params = vz.ParameterDict()
    for assignment in proto.parameters:
        params[assignment.name] = parameter_value_from_proto(assignment.value)
    trial = vz.Trial(
        id=int(proto.id),
        parameters=params,
        metadata=metadata_from_key_values(proto.metadata),
        is_requested=proto.state == study_pb2.Trial.REQUESTED,
        assigned_worker=proto.assigned_worker or None,
        stopping_reason=proto.stopping_reason or None,
        measurements=[measurement_from_proto(m) for m in proto.measurements],
    )
    if proto.state == study_pb2.Trial.STOPPING:
        trial.stop(proto.stopping_reason or None)
    if proto.state == study_pb2.Trial.SUCCEEDED and proto.HasField("final_measurement"):
        trial.final_measurement = measurement_from_proto(proto.final_measurement)
    elif proto.state == study_pb2.Trial.INFEASIBLE:
        trial.infeasibility_reason = proto.infeasibility_reason or "infeasible"
        if proto.HasField("final_measurement"):
            trial.final_measurement = measurement_from_proto(proto.final_measurement)
    if proto.creation_time_secs:
        trial.creation_time = datetime.datetime.fromtimestamp(
            proto.creation_time_secs, datetime.timezone.utc
        )
    if proto.completion_time_secs:
        trial.completion_time = datetime.datetime.fromtimestamp(
            proto.completion_time_secs, datetime.timezone.utc
        )
    return trial


def trial_suggestion_to_proto(s: vz.TrialSuggestion) -> study_pb2.Trial:
    t = vz.Trial(id=0, parameters=s.parameters, metadata=s.metadata, is_requested=True)
    return trial_to_proto(t)


# ---------------------------------------------------------------------------
# Study config
# ---------------------------------------------------------------------------


def study_config_to_proto(config: vz.StudyConfig) -> study_pb2.StudySpec:
    proto = study_pb2.StudySpec(algorithm=str(config.algorithm))
    for p in config.search_space.parameters:
        proto.parameters.add().CopyFrom(parameter_config_to_proto(p))
    for m in config.metric_information:
        proto.metrics.add().CopyFrom(metric_information_to_proto(m))
    noise_map = {
        vz.ObservationNoise.OBSERVATION_NOISE_UNSPECIFIED: study_pb2.StudySpec.OBSERVATION_NOISE_UNSPECIFIED,
        vz.ObservationNoise.LOW: study_pb2.StudySpec.LOW,
        vz.ObservationNoise.HIGH: study_pb2.StudySpec.HIGH,
    }
    proto.observation_noise = noise_map[config.observation_noise]
    if config.automated_stopping_config is not None:
        proto.early_stopping.use_steps = config.automated_stopping_config.use_steps
        proto.early_stopping.min_num_trials = config.automated_stopping_config.min_num_trials
        proto.early_stopping.rule = config.automated_stopping_config.rule
    if config.pythia_endpoint:
        proto.pythia_endpoint = config.pythia_endpoint
    proto.metadata.extend(metadata_to_key_values(config.metadata))
    return proto


def study_config_from_proto(proto: study_pb2.StudySpec) -> vz.StudyConfig:
    space = vz.SearchSpace(
        [parameter_config_from_proto(p) for p in proto.parameters]
    )
    metrics = vz.MetricsConfig(
        [metric_information_from_proto(m) for m in proto.metrics]
    )
    noise_map = {
        study_pb2.StudySpec.OBSERVATION_NOISE_UNSPECIFIED: vz.ObservationNoise.OBSERVATION_NOISE_UNSPECIFIED,
        study_pb2.StudySpec.LOW: vz.ObservationNoise.LOW,
        study_pb2.StudySpec.HIGH: vz.ObservationNoise.HIGH,
    }
    stopping = None
    if proto.HasField("early_stopping"):
        stopping = vz.AutomatedStoppingConfig(
            use_steps=proto.early_stopping.use_steps,
            min_num_trials=proto.early_stopping.min_num_trials,
            rule=proto.early_stopping.rule or "median",
        )
    return vz.StudyConfig(
        search_space=space,
        metric_information=metrics,
        metadata=metadata_from_key_values(proto.metadata),
        algorithm=proto.algorithm or vz.Algorithm.DEFAULT.value,
        observation_noise=noise_map.get(
            proto.observation_noise, vz.ObservationNoise.OBSERVATION_NOISE_UNSPECIFIED
        ),
        automated_stopping_config=stopping,
        pythia_endpoint=proto.pythia_endpoint or None,
    )


def study_to_proto(
    config: vz.StudyConfig, name: str, display_name: str = "", state: Optional[int] = None
) -> study_pb2.Study:
    proto = study_pb2.Study(
        name=name,
        display_name=display_name,
        state=state if state is not None else study_pb2.Study.ACTIVE,
        creation_time_secs=time.time(),
    )
    proto.study_spec.CopyFrom(study_config_to_proto(config))
    return proto
