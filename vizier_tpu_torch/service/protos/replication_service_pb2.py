# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: vizier_tpu_torch/service/protos/replication_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n9vizier_tpu_torch/service/protos/replication_service.proto\x12\x10vizier_tpu_torch\"W\n\x11ReplicationRecord\x12\x10\n\x03seq\x18\x01 \x01(\x04R\x03seq\x12\x16\n\x06opcode\x18\x02 \x01(\rR\x06opcode\x12\x18\n\x07payload\x18\x03 \x01(\x0cR\x07payload\"\xbd\x01\n\x15\x44\x65liverAppendsRequest\x12\x16\n\x06origin\x18\x01 \x01(\tR\x06origin\x12\x14\n\x05\x65poch\x18\x02 \x01(\x04R\x05\x65poch\x12=\n\x07records\x18\x03 \x03(\x0b\x32#.vizier_tpu_torch.ReplicationRecordR\x07records\x12\x14\n\x05reset\x18\x04 \x01(\x08R\x05reset\x12!\n\x0c\x62\x61seline_seq\x18\x05 \x01(\x04R\x0b\x62\x61selineSeq\"J\n\x16\x44\x65liverAppendsResponse\x12\x1a\n\x08\x61\x63\x63\x65pted\x18\x01 \x01(\x08R\x08\x61\x63\x63\x65pted\x12\x14\n\x05value\x18\x02 \x01(\x04R\x05value\"<\n\x0c\x46\x65nceRequest\x12\x16\n\x06origin\x18\x01 \x01(\tR\x06origin\x12\x14\n\x05\x65poch\x18\x02 \x01(\x04R\x05\x65poch\"%\n\rFenceResponse\x12\x14\n\x05\x65poch\x18\x01 \x01(\x04R\x05\x65poch\"*\n\x10HeartbeatRequest\x12\x16\n\x06sender\x18\x01 \x01(\tR\x06sender\"\x8b\x01\n\x11HeartbeatResponse\x12\x1d\n\nreplica_id\x18\x01 \x01(\tR\treplicaId\x12\x10\n\x03seq\x18\x02 \x01(\x04R\x03seq\x12+\n\x11\x66\x65nced_rejections\x18\x03 \x01(\x04R\x10\x66\x65ncedRejections\x12\x18\n\x07resyncs\x18\x04 \x01(\x04R\x07resyncs\".\n\x14\x45xportStandbyRequest\x12\x16\n\x06origin\x18\x01 \x01(\tR\x06origin\"\xa9\x01\n\x15\x45xportStandbyResponse\x12\x18\n\x07present\x18\x01 \x01(\x08R\x07present\x12!\n\x0c\x62\x61seline_seq\x18\x02 \x01(\x04R\x0b\x62\x61selineSeq\x12\x14\n\x05\x65poch\x18\x03 \x01(\x04R\x05\x65poch\x12=\n\x07records\x18\x04 \x03(\x0b\x32#.vizier_tpu_torch.ReplicationRecordR\x07records\".\n\x12\x45xportStateRequest\x12\x18\n\x07studies\x18\x01 \x03(\tR\x07studies\"f\n\x13\x45xportStateResponse\x12\x10\n\x03seq\x18\x01 \x01(\x04R\x03seq\x12=\n\x07records\x18\x02 \x03(\x0b\x32#.vizier_tpu_torch.ReplicationRecordR\x07records\"T\n\x13\x41pplyRecordsRequest\x12=\n\x07records\x18\x01 \x03(\x0b\x32#.vizier_tpu_torch.ReplicationRecordR\x07records\"0\n\x14\x41pplyRecordsResponse\x12\x18\n\x07\x61pplied\x18\x01 \x01(\rR\x07\x61pplied\"-\n\rResyncRequest\x12\x1c\n\tsuccessor\x18\x01 \x01(\tR\tsuccessor\".\n\x0eResyncResponse\x12\x1c\n\trequested\x18\x01 \x01(\x08R\trequested\"7\n\x12\x46lushStreamRequest\x12!\n\x0ctimeout_secs\x18\x01 \x01(\x01R\x0btimeoutSecs\"/\n\x13\x46lushStreamResponse\x12\x18\n\x07\x66lushed\x18\x01 \x01(\x08R\x07\x66lushed2\xbe\x06\n\x12ReplicationService\x12\x63\n\x0e\x44\x65liverAppends\x12\'.vizier_tpu_torch.DeliverAppendsRequest\x1a(.vizier_tpu_torch.DeliverAppendsResponse\x12]\n\x08\x42\x61seline\x12\'.vizier_tpu_torch.DeliverAppendsRequest\x1a(.vizier_tpu_torch.DeliverAppendsResponse\x12H\n\x05\x46\x65nce\x12\x1e.vizier_tpu_torch.FenceRequest\x1a\x1f.vizier_tpu_torch.FenceResponse\x12T\n\tHeartbeat\x12\".vizier_tpu_torch.HeartbeatRequest\x1a#.vizier_tpu_torch.HeartbeatResponse\x12`\n\rExportStandby\x12&.vizier_tpu_torch.ExportStandbyRequest\x1a\'.vizier_tpu_torch.ExportStandbyResponse\x12Z\n\x0b\x45xportState\x12$.vizier_tpu_torch.ExportStateRequest\x1a%.vizier_tpu_torch.ExportStateResponse\x12]\n\x0c\x41pplyRecords\x12%.vizier_tpu_torch.ApplyRecordsRequest\x1a&.vizier_tpu_torch.ApplyRecordsResponse\x12K\n\x06Resync\x12\x1f.vizier_tpu_torch.ResyncRequest\x1a .vizier_tpu_torch.ResyncResponse\x12Z\n\x0b\x46lushStream\x12$.vizier_tpu_torch.FlushStreamRequest\x1a%.vizier_tpu_torch.FlushStreamResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'vizier_tpu_torch.service.protos.replication_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REPLICATIONRECORD._serialized_start=79
  _REPLICATIONRECORD._serialized_end=166
  _DELIVERAPPENDSREQUEST._serialized_start=169
  _DELIVERAPPENDSREQUEST._serialized_end=358
  _DELIVERAPPENDSRESPONSE._serialized_start=360
  _DELIVERAPPENDSRESPONSE._serialized_end=434
  _FENCEREQUEST._serialized_start=436
  _FENCEREQUEST._serialized_end=496
  _FENCERESPONSE._serialized_start=498
  _FENCERESPONSE._serialized_end=535
  _HEARTBEATREQUEST._serialized_start=537
  _HEARTBEATREQUEST._serialized_end=579
  _HEARTBEATRESPONSE._serialized_start=582
  _HEARTBEATRESPONSE._serialized_end=721
  _EXPORTSTANDBYREQUEST._serialized_start=723
  _EXPORTSTANDBYREQUEST._serialized_end=769
  _EXPORTSTANDBYRESPONSE._serialized_start=772
  _EXPORTSTANDBYRESPONSE._serialized_end=941
  _EXPORTSTATEREQUEST._serialized_start=943
  _EXPORTSTATEREQUEST._serialized_end=989
  _EXPORTSTATERESPONSE._serialized_start=991
  _EXPORTSTATERESPONSE._serialized_end=1093
  _APPLYRECORDSREQUEST._serialized_start=1095
  _APPLYRECORDSREQUEST._serialized_end=1179
  _APPLYRECORDSRESPONSE._serialized_start=1181
  _APPLYRECORDSRESPONSE._serialized_end=1229
  _RESYNCREQUEST._serialized_start=1231
  _RESYNCREQUEST._serialized_end=1276
  _RESYNCRESPONSE._serialized_start=1278
  _RESYNCRESPONSE._serialized_end=1324
  _FLUSHSTREAMREQUEST._serialized_start=1326
  _FLUSHSTREAMREQUEST._serialized_end=1381
  _FLUSHSTREAMRESPONSE._serialized_start=1383
  _FLUSHSTREAMRESPONSE._serialized_end=1430
  _REPLICATIONSERVICE._serialized_start=1433
  _REPLICATIONSERVICE._serialized_end=2263
# @@protoc_insertion_point(module_scope)
