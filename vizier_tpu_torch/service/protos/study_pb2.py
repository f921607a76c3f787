# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: vizier_tpu_torch/service/protos/study.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from vizier_tpu_torch.service.protos import key_value_pb2 as vizier__tpu__torch_dot_service_dot_protos_dot_key__value__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n+vizier_tpu_torch/service/protos/study.proto\x12\x10vizier_tpu_torch\x1a/vizier_tpu_torch/service/protos/key_value.proto\"3\n\x0b\x44oubleRange\x12\x11\n\tmin_value\x18\x01 \x01(\x01\x12\x11\n\tmax_value\x18\x02 \x01(\x01\"4\n\x0cIntegerRange\x12\x11\n\tmin_value\x18\x01 \x01(\x03\x12\x11\n\tmax_value\x18\x02 \x01(\x03\" \n\x0e\x44iscreteValues\x12\x0e\n\x06values\x18\x01 \x03(\x01\"#\n\x11\x43\x61tegoricalValues\x12\x0e\n\x06values\x18\x01 \x03(\t\"\xc1\x06\n\rParameterSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12=\n\nscale_type\x18\x02 \x01(\x0e\x32).vizier_tpu_torch.ParameterSpec.ScaleType\x12\x35\n\x0c\x64ouble_range\x18\x03 \x01(\x0b\x32\x1d.vizier_tpu_torch.DoubleRangeH\x00\x12\x37\n\rinteger_range\x18\x04 \x01(\x0b\x32\x1e.vizier_tpu_torch.IntegerRangeH\x00\x12;\n\x0f\x64iscrete_values\x18\x05 \x01(\x0b\x32 .vizier_tpu_torch.DiscreteValuesH\x00\x12\x41\n\x12\x63\x61tegorical_values\x18\x06 \x01(\x0b\x32#.vizier_tpu_torch.CategoricalValuesH\x00\x12\x43\n\rexternal_type\x18\x07 \x01(\x0e\x32,.vizier_tpu_torch.ParameterSpec.ExternalType\x12\x37\n\rdefault_value\x18\x08 \x01(\x0b\x32 .vizier_tpu_torch.ParameterValue\x12\x42\n\x08\x63hildren\x18\t \x03(\x0b\x32\x30.vizier_tpu_torch.ParameterSpec.ConditionalChild\x1a\x83\x01\n\x10\x43onditionalChild\x12@\n\x16matching_parent_values\x18\x01 \x03(\x0b\x32 .vizier_tpu_torch.ParameterValue\x12-\n\x04spec\x18\x02 \x01(\x0b\x32\x1f.vizier_tpu_torch.ParameterSpec\"^\n\tScaleType\x12\x15\n\x11SCALE_UNSPECIFIED\x10\x00\x12\n\n\x06LINEAR\x10\x01\x12\x07\n\x03LOG\x10\x02\x12\x0f\n\x0bREVERSE_LOG\x10\x03\x12\x14\n\x10UNIFORM_DISCRETE\x10\x04\"A\n\x0c\x45xternalType\x12\x0c\n\x08INTERNAL\x10\x00\x12\x0b\n\x07\x42OOLEAN\x10\x01\x12\x0b\n\x07INTEGER\x10\x02\x12\t\n\x05\x46LOAT\x10\x03\x42\x08\n\x06\x64omain\"t\n\x0eParameterValue\x12\x16\n\x0c\x64ouble_value\x18\x01 \x01(\x01H\x00\x12\x13\n\tint_value\x18\x02 \x01(\x03H\x00\x12\x16\n\x0cstring_value\x18\x03 \x01(\tH\x00\x12\x14\n\nbool_value\x18\x04 \x01(\x08H\x00\x42\x07\n\x05value\"T\n\x13ParameterAssignment\x12\x0c\n\x04name\x18\x01 \x01(\t\x12/\n\x05value\x18\x02 \x01(\x0b\x32 .vizier_tpu_torch.ParameterValue\"\xa8\x03\n\nMetricSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12/\n\x04goal\x18\x02 \x01(\x0e\x32!.vizier_tpu_torch.MetricSpec.Goal\x12\x45\n\rsafety_config\x18\x03 \x01(\x0b\x32).vizier_tpu_torch.MetricSpec.SafetyConfigH\x00\x88\x01\x01\x12\x16\n\tmin_value\x18\x04 \x01(\x01H\x01\x88\x01\x01\x12\x16\n\tmax_value\x18\x05 \x01(\x01H\x02\x88\x01\x01\x1a|\n\x0cSafetyConfig\x12\x18\n\x10safety_threshold\x18\x01 \x01(\x01\x12-\n desired_min_safe_trials_fraction\x18\x02 \x01(\x01H\x00\x88\x01\x01\x42#\n!_desired_min_safe_trials_fraction\"8\n\x04Goal\x12\x14\n\x10GOAL_UNSPECIFIED\x10\x00\x12\x0c\n\x08MAXIMIZE\x10\x01\x12\x0c\n\x08MINIMIZE\x10\x02\x42\x10\n\x0e_safety_configB\x0c\n\n_min_valueB\x0c\n\n_max_value\"\xaa\x01\n\x0bMeasurement\x12\x14\n\x0c\x65lapsed_secs\x18\x01 \x01(\x01\x12\r\n\x05steps\x18\x02 \x01(\x01\x12\x35\n\x07metrics\x18\x03 \x03(\x0b\x32$.vizier_tpu_torch.Measurement.Metric\x1a?\n\x06Metric\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01\x12\x10\n\x03std\x18\x03 \x01(\x01H\x00\x88\x01\x01\x42\x06\n\x04_std\"L\n\x11\x45\x61rlyStoppingSpec\x12\x11\n\tuse_steps\x18\x01 \x01(\x08\x12\x16\n\x0emin_num_trials\x18\x02 \x01(\x05\x12\x0c\n\x04rule\x18\x03 \x01(\t\"\xb1\x03\n\tStudySpec\x12\x33\n\nparameters\x18\x01 \x03(\x0b\x32\x1f.vizier_tpu_torch.ParameterSpec\x12-\n\x07metrics\x18\x02 \x03(\x0b\x32\x1c.vizier_tpu_torch.MetricSpec\x12\x11\n\talgorithm\x18\x03 \x01(\t\x12G\n\x11observation_noise\x18\x04 \x01(\x0e\x32,.vizier_tpu_torch.StudySpec.ObservationNoise\x12@\n\x0e\x65\x61rly_stopping\x18\x05 \x01(\x0b\x32#.vizier_tpu_torch.EarlyStoppingSpecH\x00\x88\x01\x01\x12,\n\x08metadata\x18\x06 \x03(\x0b\x32\x1a.vizier_tpu_torch.KeyValue\x12\x17\n\x0fpythia_endpoint\x18\x07 \x01(\t\"H\n\x10ObservationNoise\x12!\n\x1dOBSERVATION_NOISE_UNSPECIFIED\x10\x00\x12\x07\n\x03LOW\x10\x01\x12\x08\n\x04HIGH\x10\x02\x42\x11\n\x0f_early_stopping\"\x85\x02\n\x05Study\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0c\x64isplay_name\x18\x02 \x01(\t\x12/\n\nstudy_spec\x18\x03 \x01(\x0b\x32\x1b.vizier_tpu_torch.StudySpec\x12,\n\x05state\x18\x04 \x01(\x0e\x32\x1d.vizier_tpu_torch.Study.State\x12\x14\n\x0cstate_reason\x18\x05 \x01(\t\x12\x1a\n\x12\x63reation_time_secs\x18\x06 \x01(\x01\"G\n\x05State\x12\x15\n\x11STATE_UNSPECIFIED\x10\x00\x12\n\n\x06\x41\x43TIVE\x10\x01\x12\x0c\n\x08INACTIVE\x10\x02\x12\r\n\tCOMPLETED\x10\x03\"\xb4\x04\n\x05Trial\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\x03\x12,\n\x05state\x18\x03 \x01(\x0e\x32\x1d.vizier_tpu_torch.Trial.State\x12\x39\n\nparameters\x18\x04 \x03(\x0b\x32%.vizier_tpu_torch.ParameterAssignment\x12\x33\n\x0cmeasurements\x18\x05 \x03(\x0b\x32\x1d.vizier_tpu_torch.Measurement\x12=\n\x11\x66inal_measurement\x18\x06 \x01(\x0b\x32\x1d.vizier_tpu_torch.MeasurementH\x00\x88\x01\x01\x12\x1c\n\x14infeasibility_reason\x18\x07 \x01(\t\x12\x17\n\x0f\x61ssigned_worker\x18\x08 \x01(\t\x12\x17\n\x0fstopping_reason\x18\t \x01(\t\x12,\n\x08metadata\x18\n \x03(\x0b\x32\x1a.vizier_tpu_torch.KeyValue\x12\x1a\n\x12\x63reation_time_secs\x18\x0b \x01(\x01\x12\x1c\n\x14\x63ompletion_time_secs\x18\x0c \x01(\x01\"f\n\x05State\x12\x15\n\x11STATE_UNSPECIFIED\x10\x00\x12\r\n\tREQUESTED\x10\x01\x12\n\n\x06\x41\x43TIVE\x10\x02\x12\x0c\n\x08STOPPING\x10\x03\x12\r\n\tSUCCEEDED\x10\x04\x12\x0e\n\nINFEASIBLE\x10\x05\x42\x14\n\x12_final_measurementb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'vizier_tpu_torch.service.protos.study_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DOUBLERANGE._serialized_start=114
  _DOUBLERANGE._serialized_end=165
  _INTEGERRANGE._serialized_start=167
  _INTEGERRANGE._serialized_end=219
  _DISCRETEVALUES._serialized_start=221
  _DISCRETEVALUES._serialized_end=253
  _CATEGORICALVALUES._serialized_start=255
  _CATEGORICALVALUES._serialized_end=290
  _PARAMETERSPEC._serialized_start=293
  _PARAMETERSPEC._serialized_end=1126
  _PARAMETERSPEC_CONDITIONALCHILD._serialized_start=822
  _PARAMETERSPEC_CONDITIONALCHILD._serialized_end=953
  _PARAMETERSPEC_SCALETYPE._serialized_start=955
  _PARAMETERSPEC_SCALETYPE._serialized_end=1049
  _PARAMETERSPEC_EXTERNALTYPE._serialized_start=1051
  _PARAMETERSPEC_EXTERNALTYPE._serialized_end=1116
  _PARAMETERVALUE._serialized_start=1128
  _PARAMETERVALUE._serialized_end=1244
  _PARAMETERASSIGNMENT._serialized_start=1246
  _PARAMETERASSIGNMENT._serialized_end=1330
  _METRICSPEC._serialized_start=1333
  _METRICSPEC._serialized_end=1757
  _METRICSPEC_SAFETYCONFIG._serialized_start=1529
  _METRICSPEC_SAFETYCONFIG._serialized_end=1653
  _METRICSPEC_GOAL._serialized_start=1655
  _METRICSPEC_GOAL._serialized_end=1711
  _MEASUREMENT._serialized_start=1760
  _MEASUREMENT._serialized_end=1930
  _MEASUREMENT_METRIC._serialized_start=1867
  _MEASUREMENT_METRIC._serialized_end=1930
  _EARLYSTOPPINGSPEC._serialized_start=1932
  _EARLYSTOPPINGSPEC._serialized_end=2008
  _STUDYSPEC._serialized_start=2011
  _STUDYSPEC._serialized_end=2444
  _STUDYSPEC_OBSERVATIONNOISE._serialized_start=2353
  _STUDYSPEC_OBSERVATIONNOISE._serialized_end=2425
  _STUDY._serialized_start=2447
  _STUDY._serialized_end=2708
  _STUDY_STATE._serialized_start=2637
  _STUDY_STATE._serialized_end=2708
  _TRIAL._serialized_start=2711
  _TRIAL._serialized_end=3275
  _TRIAL_STATE._serialized_start=3151
  _TRIAL_STATE._serialized_end=3253
# @@protoc_insertion_point(module_scope)
