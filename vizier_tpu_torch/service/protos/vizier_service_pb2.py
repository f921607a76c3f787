# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: vizier_tpu_torch/service/protos/vizier_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from vizier_tpu_torch.service.protos import study_pb2 as vizier__tpu__torch_dot_service_dot_protos_dot_study__pb2
from vizier_tpu_torch.service.protos import key_value_pb2 as vizier__tpu__torch_dot_service_dot_protos_dot_key__value__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n4vizier_tpu_torch/service/protos/vizier_service.proto\x12\x10vizier_tpu_torch\x1a+vizier_tpu_torch/service/protos/study.proto\x1a/vizier_tpu_torch/service/protos/key_value.proto\"q\n\tOperation\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04\x64one\x18\x02 \x01(\x08\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x39\n\x08response\x18\x04 \x01(\x0b\x32\'.vizier_tpu_torch.SuggestTrialsResponse\"L\n\x12\x43reateStudyRequest\x12\x0e\n\x06parent\x18\x01 \x01(\t\x12&\n\x05study\x18\x02 \x01(\x0b\x32\x17.vizier_tpu_torch.Study\"\x1f\n\x0fGetStudyRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"$\n\x12ListStudiesRequest\x12\x0e\n\x06parent\x18\x01 \x01(\t\"?\n\x13ListStudiesResponse\x12(\n\x07studies\x18\x01 \x03(\x0b\x32\x17.vizier_tpu_torch.Study\"\"\n\x12\x44\x65leteStudyRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"b\n\x14SetStudyStateRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12,\n\x05state\x18\x02 \x01(\x0e\x32\x1d.vizier_tpu_torch.Study.State\x12\x0e\n\x06reason\x18\x03 \x01(\t\"\x07\n\x05\x45mpty\"\x9d\x01\n\x14SuggestTrialsRequest\x12\x0e\n\x06parent\x18\x01 \x01(\t\x12\x18\n\x10suggestion_count\x18\x02 \x01(\x05\x12\x11\n\tclient_id\x18\x03 \x01(\t\x12#\n\rdeadline_secs\x18\x04 \x01(\x01R\x0c\x64\x65\x61\x64lineSecs\x12#\n\rtrace_context\x18\x05 \x01(\tR\x0ctraceContext\"@\n\x15SuggestTrialsResponse\x12\'\n\x06trials\x18\x01 \x03(\x0b\x32\x17.vizier_tpu_torch.Trial\"#\n\x13GetOperationRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"L\n\x12\x43reateTrialRequest\x12\x0e\n\x06parent\x18\x01 \x01(\t\x12&\n\x05trial\x18\x02 \x01(\x0b\x32\x17.vizier_tpu_torch.Trial\"\x1f\n\x0fGetTrialRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"#\n\x11ListTrialsRequest\x12\x0e\n\x06parent\x18\x01 \x01(\t\"=\n\x12ListTrialsResponse\x12\'\n\x06trials\x18\x01 \x03(\x0b\x32\x17.vizier_tpu_torch.Trial\"d\n\x1a\x41\x64\x64TrialMeasurementRequest\x12\x12\n\ntrial_name\x18\x01 \x01(\t\x12\x32\n\x0bmeasurement\x18\x02 \x01(\x0b\x32\x1d.vizier_tpu_torch.Measurement\"\xae\x01\n\x14\x43ompleteTrialRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12=\n\x11\x66inal_measurement\x18\x02 \x01(\x0b\x32\x1d.vizier_tpu_torch.MeasurementH\x00\x88\x01\x01\x12\x18\n\x10trial_infeasible\x18\x03 \x01(\x08\x12\x19\n\x11infeasible_reason\x18\x04 \x01(\tB\x14\n\x12_final_measurement\"\"\n\x12\x44\x65leteTrialRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\" \n\x10StopTrialRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"9\n#CheckTrialEarlyStoppingStateRequest\x12\x12\n\ntrial_name\x18\x01 \x01(\t\";\n$CheckTrialEarlyStoppingStateResponse\x12\x13\n\x0bshould_stop\x18\x01 \x01(\x08\"*\n\x18ListOptimalTrialsRequest\x12\x0e\n\x06parent\x18\x01 \x01(\t\"L\n\x19ListOptimalTrialsResponse\x12/\n\x0eoptimal_trials\x18\x01 \x03(\x0b\x32\x17.vizier_tpu_torch.Trial\"\xee\x01\n\x16\x45\x61rlyStoppingOperation\x12\x0c\n\x04name\x18\x01 \x01(\t\x12?\n\x06status\x18\x02 \x01(\x0e\x32/.vizier_tpu_torch.EarlyStoppingOperation.Status\x12\x13\n\x0bshould_stop\x18\x03 \x01(\x08\x12\x1a\n\x12\x63reation_time_secs\x18\x04 \x01(\x01\x12\x1c\n\x14\x63ompletion_time_secs\x18\x05 \x01(\x01\"6\n\x06Status\x12\x16\n\x12STATUS_UNSPECIFIED\x10\x00\x12\n\n\x06\x41\x43TIVE\x10\x01\x12\x08\n\x04\x44ONE\x10\x02\"U\n\x12UnitMetadataUpdate\x12\x10\n\x08trial_id\x18\x01 \x01(\x03\x12-\n\tkey_value\x18\x02 \x01(\x0b\x32\x1a.vizier_tpu_torch.KeyValue\"[\n\x15UpdateMetadataRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x34\n\x06\x64\x65ltas\x18\x02 \x03(\x0b\x32$.vizier_tpu_torch.UnitMetadataUpdate\"/\n\x16UpdateMetadataResponse\x12\x15\n\rerror_details\x18\x01 \x01(\t2\xe5\x0b\n\rVizierService\x12L\n\x0b\x43reateStudy\x12$.vizier_tpu_torch.CreateStudyRequest\x1a\x17.vizier_tpu_torch.Study\x12\x46\n\x08GetStudy\x12!.vizier_tpu_torch.GetStudyRequest\x1a\x17.vizier_tpu_torch.Study\x12Z\n\x0bListStudies\x12$.vizier_tpu_torch.ListStudiesRequest\x1a%.vizier_tpu_torch.ListStudiesResponse\x12L\n\x0b\x44\x65leteStudy\x12$.vizier_tpu_torch.DeleteStudyRequest\x1a\x17.vizier_tpu_torch.Empty\x12P\n\rSetStudyState\x12&.vizier_tpu_torch.SetStudyStateRequest\x1a\x17.vizier_tpu_torch.Study\x12T\n\rSuggestTrials\x12&.vizier_tpu_torch.SuggestTrialsRequest\x1a\x1b.vizier_tpu_torch.Operation\x12R\n\x0cGetOperation\x12%.vizier_tpu_torch.GetOperationRequest\x1a\x1b.vizier_tpu_torch.Operation\x12L\n\x0b\x43reateTrial\x12$.vizier_tpu_torch.CreateTrialRequest\x1a\x17.vizier_tpu_torch.Trial\x12\x46\n\x08GetTrial\x12!.vizier_tpu_torch.GetTrialRequest\x1a\x17.vizier_tpu_torch.Trial\x12W\n\nListTrials\x12#.vizier_tpu_torch.ListTrialsRequest\x1a$.vizier_tpu_torch.ListTrialsResponse\x12\\\n\x13\x41\x64\x64TrialMeasurement\x12,.vizier_tpu_torch.AddTrialMeasurementRequest\x1a\x17.vizier_tpu_torch.Trial\x12P\n\rCompleteTrial\x12&.vizier_tpu_torch.CompleteTrialRequest\x1a\x17.vizier_tpu_torch.Trial\x12L\n\x0b\x44\x65leteTrial\x12$.vizier_tpu_torch.DeleteTrialRequest\x1a\x17.vizier_tpu_torch.Empty\x12\x8d\x01\n\x1c\x43heckTrialEarlyStoppingState\x12\x35.vizier_tpu_torch.CheckTrialEarlyStoppingStateRequest\x1a\x36.vizier_tpu_torch.CheckTrialEarlyStoppingStateResponse\x12H\n\tStopTrial\x12\".vizier_tpu_torch.StopTrialRequest\x1a\x17.vizier_tpu_torch.Trial\x12l\n\x11ListOptimalTrials\x12*.vizier_tpu_torch.ListOptimalTrialsRequest\x1a+.vizier_tpu_torch.ListOptimalTrialsResponse\x12\x63\n\x0eUpdateMetadata\x12\'.vizier_tpu_torch.UpdateMetadataRequest\x1a(.vizier_tpu_torch.UpdateMetadataResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'vizier_tpu_torch.service.protos.vizier_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _OPERATION._serialized_start=168
  _OPERATION._serialized_end=281
  _CREATESTUDYREQUEST._serialized_start=283
  _CREATESTUDYREQUEST._serialized_end=359
  _GETSTUDYREQUEST._serialized_start=361
  _GETSTUDYREQUEST._serialized_end=392
  _LISTSTUDIESREQUEST._serialized_start=394
  _LISTSTUDIESREQUEST._serialized_end=430
  _LISTSTUDIESRESPONSE._serialized_start=432
  _LISTSTUDIESRESPONSE._serialized_end=495
  _DELETESTUDYREQUEST._serialized_start=497
  _DELETESTUDYREQUEST._serialized_end=531
  _SETSTUDYSTATEREQUEST._serialized_start=533
  _SETSTUDYSTATEREQUEST._serialized_end=631
  _EMPTY._serialized_start=633
  _EMPTY._serialized_end=640
  _SUGGESTTRIALSREQUEST._serialized_start=643
  _SUGGESTTRIALSREQUEST._serialized_end=800
  _SUGGESTTRIALSRESPONSE._serialized_start=802
  _SUGGESTTRIALSRESPONSE._serialized_end=866
  _GETOPERATIONREQUEST._serialized_start=868
  _GETOPERATIONREQUEST._serialized_end=903
  _CREATETRIALREQUEST._serialized_start=905
  _CREATETRIALREQUEST._serialized_end=981
  _GETTRIALREQUEST._serialized_start=983
  _GETTRIALREQUEST._serialized_end=1014
  _LISTTRIALSREQUEST._serialized_start=1016
  _LISTTRIALSREQUEST._serialized_end=1051
  _LISTTRIALSRESPONSE._serialized_start=1053
  _LISTTRIALSRESPONSE._serialized_end=1114
  _ADDTRIALMEASUREMENTREQUEST._serialized_start=1116
  _ADDTRIALMEASUREMENTREQUEST._serialized_end=1216
  _COMPLETETRIALREQUEST._serialized_start=1219
  _COMPLETETRIALREQUEST._serialized_end=1393
  _DELETETRIALREQUEST._serialized_start=1395
  _DELETETRIALREQUEST._serialized_end=1429
  _STOPTRIALREQUEST._serialized_start=1431
  _STOPTRIALREQUEST._serialized_end=1463
  _CHECKTRIALEARLYSTOPPINGSTATEREQUEST._serialized_start=1465
  _CHECKTRIALEARLYSTOPPINGSTATEREQUEST._serialized_end=1522
  _CHECKTRIALEARLYSTOPPINGSTATERESPONSE._serialized_start=1524
  _CHECKTRIALEARLYSTOPPINGSTATERESPONSE._serialized_end=1583
  _LISTOPTIMALTRIALSREQUEST._serialized_start=1585
  _LISTOPTIMALTRIALSREQUEST._serialized_end=1627
  _LISTOPTIMALTRIALSRESPONSE._serialized_start=1629
  _LISTOPTIMALTRIALSRESPONSE._serialized_end=1705
  _EARLYSTOPPINGOPERATION._serialized_start=1708
  _EARLYSTOPPINGOPERATION._serialized_end=1946
  _EARLYSTOPPINGOPERATION_STATUS._serialized_start=1892
  _EARLYSTOPPINGOPERATION_STATUS._serialized_end=1946
  _UNITMETADATAUPDATE._serialized_start=1948
  _UNITMETADATAUPDATE._serialized_end=2033
  _UPDATEMETADATAREQUEST._serialized_start=2035
  _UPDATEMETADATAREQUEST._serialized_end=2126
  _UPDATEMETADATARESPONSE._serialized_start=2128
  _UPDATEMETADATARESPONSE._serialized_end=2175
  _VIZIERSERVICE._serialized_start=2178
  _VIZIERSERVICE._serialized_end=3687
# @@protoc_insertion_point(module_scope)
