# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: vizier_tpu_torch/service/protos/pythia_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from vizier_tpu_torch.service.protos import study_pb2 as vizier__tpu__torch_dot_service_dot_protos_dot_study__pb2
from vizier_tpu_torch.service.protos import key_value_pb2 as vizier__tpu__torch_dot_service_dot_protos_dot_key__value__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n4vizier_tpu_torch/service/protos/pythia_service.proto\x12\x10vizier_tpu_torch\x1a+vizier_tpu_torch/service/protos/study.proto\x1a/vizier_tpu_torch/service/protos/key_value.proto\"g\n\x14StudyDescriptorProto\x12+\n\x06\x63onfig\x18\x01 \x01(\x0b\x32\x1b.vizier_tpu_torch.StudySpec\x12\x0c\n\x04guid\x18\x02 \x01(\t\x12\x14\n\x0cmax_trial_id\x18\x03 \x01(\x03\"\xd8\x01\n\x14PythiaSuggestRequest\x12@\n\x10study_descriptor\x18\x01 \x01(\x0b\x32&.vizier_tpu_torch.StudyDescriptorProto\x12\r\n\x05\x63ount\x18\x02 \x01(\x05\x12\x11\n\talgorithm\x18\x03 \x01(\t\x12\x12\n\nstudy_name\x18\x04 \x01(\t\x12#\n\rdeadline_secs\x18\x05 \x01(\x01R\x0c\x64\x65\x61\x64lineSecs\x12#\n\rtrace_context\x18\x06 \x01(\tR\x0ctraceContext\"\x93\x01\n\x15PythiaSuggestResponse\x12,\n\x0bsuggestions\x18\x01 \x03(\x0b\x32\x17.vizier_tpu_torch.Trial\x12=\n\x0fmetadata_deltas\x18\x02 \x03(\x0b\x32$.vizier_tpu_torch.MetadataDeltaProto\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"V\n\x12MetadataDeltaProto\x12\x10\n\x08trial_id\x18\x01 \x01(\x03\x12.\n\nkey_values\x18\x02 \x03(\x0b\x32\x1a.vizier_tpu_torch.KeyValue\"\x94\x01\n\x16PythiaEarlyStopRequest\x12@\n\x10study_descriptor\x18\x01 \x01(\x0b\x32&.vizier_tpu_torch.StudyDescriptorProto\x12\x11\n\ttrial_ids\x18\x02 \x03(\x03\x12\x11\n\talgorithm\x18\x03 \x01(\t\x12\x12\n\nstudy_name\x18\x04 \x01(\t\"I\n\x16\x45\x61rlyStopDecisionProto\x12\n\n\x02id\x18\x01 \x01(\x03\x12\x13\n\x0bshould_stop\x18\x02 \x01(\x08\x12\x0e\n\x06reason\x18\x03 \x01(\t\"e\n\x17PythiaEarlyStopResponse\x12;\n\tdecisions\x18\x01 \x03(\x0b\x32(.vizier_tpu_torch.EarlyStopDecisionProto\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\r\n\x0bPingRequest\"\x0e\n\x0cPingResponse2\x94\x02\n\rPythiaService\x12Z\n\x07Suggest\x12&.vizier_tpu_torch.PythiaSuggestRequest\x1a\'.vizier_tpu_torch.PythiaSuggestResponse\x12`\n\tEarlyStop\x12(.vizier_tpu_torch.PythiaEarlyStopRequest\x1a).vizier_tpu_torch.PythiaEarlyStopResponse\x12\x45\n\x04Ping\x12\x1d.vizier_tpu_torch.PingRequest\x1a\x1e.vizier_tpu_torch.PingResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'vizier_tpu_torch.service.protos.pythia_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _STUDYDESCRIPTORPROTO._serialized_start=168
  _STUDYDESCRIPTORPROTO._serialized_end=271
  _PYTHIASUGGESTREQUEST._serialized_start=274
  _PYTHIASUGGESTREQUEST._serialized_end=490
  _PYTHIASUGGESTRESPONSE._serialized_start=493
  _PYTHIASUGGESTRESPONSE._serialized_end=640
  _METADATADELTAPROTO._serialized_start=642
  _METADATADELTAPROTO._serialized_end=728
  _PYTHIAEARLYSTOPREQUEST._serialized_start=731
  _PYTHIAEARLYSTOPREQUEST._serialized_end=879
  _EARLYSTOPDECISIONPROTO._serialized_start=881
  _EARLYSTOPDECISIONPROTO._serialized_end=954
  _PYTHIAEARLYSTOPRESPONSE._serialized_start=956
  _PYTHIAEARLYSTOPRESPONSE._serialized_end=1057
  _PINGREQUEST._serialized_start=1059
  _PINGREQUEST._serialized_end=1072
  _PINGRESPONSE._serialized_start=1074
  _PINGRESPONSE._serialized_end=1088
  _PYTHIASERVICE._serialized_start=1091
  _PYTHIASERVICE._serialized_end=1367
# @@protoc_insertion_point(module_scope)
