# -*- coding: utf-8 -*-
# Generated by scripts/gen_proto.py (no protoc in the image).  DO NOT
# EDIT BY HAND — change scripts/gen_proto.py EDITS + proto/elastic.proto
# and rerun the script.
# source: elastic.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\relastic.proto\x12\relasticdl_tpu"w\n\x08TensorPB\x12\r\n\x05dtype\x18\x01 \x01(\t\x12\x0c\n\x04dims\x18\x02 \x03(\x03\x12\x0f\n\x07content\x18\x03 \x01(\x0c\x12\x1d\n\nwire_dtype\x18\x04 \x01(\tR\twireDtype\x12\x1e\n\ngeneration\x18\x05 \x01(\x03R\ngeneration"G\n\x0fIndexedSlicesPB\x12\'\n\x06values\x18\x01 \x01(\x0b2\x17.elasticdl_tpu.TensorPB\x12\x0b\n\x03ids\x18\x02 \x03(\x03"U\n\x14EmbeddingTableInfoPB\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0b\n\x03dim\x18\x02 \x01(\x03\x12\x13\n\x0binitializer\x18\x03 \x01(\t\x12\r\n\x05dtype\x18\x04 \x01(\t"\x95\x03\n\x07ModelPB\x12\x0f\n\x07version\x18\x01 \x01(\x05\x12E\n\x10dense_parameters\x18\x02 \x03(\x0b2+.elasticdl_tpu.ModelPB.DenseParametersEntry\x12E\n\x10embedding_tables\x18\x03 \x03(\x0b2+.elasticdl_tpu.ModelPB.EmbeddingTablesEntry\x12B\n\x15embedding_table_infos\x18\x04 \x03(\x0b2#.elasticdl_tpu.EmbeddingTableInfoPB\x1aO\n\x14DenseParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12&\n\x05value\x18\x02 \x01(\x0b2\x17.elasticdl_tpu.TensorPB:\x028\x01\x1aV\n\x14EmbeddingTablesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12-\n\x05value\x18\x02 \x01(\x0b2\x1e.elasticdl_tpu.IndexedSlicesPB:\x028\x01"K\n\x07ShardPB\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05start\x18\x02 \x01(\x03\x12\x0b\n\x03end\x18\x03 \x01(\x03\x12\x16\n\x0erecord_indices\x18\x04 \x03(\x03"\x92\x01\n\x06TaskPB\x12\n\n\x02id\x18\x01 \x01(\x05\x12\'\n\x04type\x18\x02 \x01(\x0e2\x19.elasticdl_tpu.TaskTypePB\x12%\n\x05shard\x18\x03 \x01(\x0b2\x16.elasticdl_tpu.ShardPB\x12\x15\n\rmodel_version\x18\x04 \x01(\x05\x12\x15\n\x06job_id\x18\x05 \x01(\x05R\x05jobId"h\n\x0eGetTaskRequest\x12\x11\n\tworker_id\x18\x01 \x01(\x05\x12,\n\ttask_type\x18\x02 \x01(\x0e2\x19.elasticdl_tpu.TaskTypePB\x12\x15\n\x06job_id\x18\x03 \x01(\x05R\x05jobId"l\n\x0fGetTaskResponse\x12#\n\x04task\x18\x01 \x01(\x0b2\x15.elasticdl_tpu.TaskPB\x12\x15\n\x06job_id\x18\x02 \x01(\x05R\x05jobId\x12\x1d\n\njob_config\x18\x03 \x01(\tR\tjobConfig"\xed\x01\n\x17ReportTaskResultRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\x05\x12\x13\n\x0berr_message\x18\x02 \x01(\t\x12O\n\rexec_counters\x18\x03 \x03(\x0b28.elasticdl_tpu.ReportTaskResultRequest.ExecCountersEntry\x12\x0f\n\x07requeue\x18\x04 \x01(\x08\x12\x15\n\x06job_id\x18\x05 \x01(\x05R\x05jobId\x1a3\n\x11ExecCountersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x028\x01"\xa7\x02\n\x16ReportBatchDoneRequest\x12\x11\n\tworker_id\x18\x01 \x01(\x05\x12\x14\n\x0crecord_count\x18\x02 \x01(\x03\x12"\n\rsteps_per_sec\x18\x03 \x01(\x01R\x0bstepsPerSec\x12#\n\rsync_fraction\x18\x04 \x01(\x01R\x0csyncFraction\x12%\n\x0epush_staleness\x18\x05 \x01(\x01R\rpushStaleness\x12\x1f\n\x0bwindow_size\x18\x06 \x01(\x01R\nwindowSize\x12\x1d\n\nsteps_done\x18\x07 \x01(\x03R\tstepsDone\x12\x15\n\x06job_id\x18\x08 \x01(\x05R\x05jobId\x12\x1d\n\nhist_delta\x18\t \x01(\tR\thistDelta"@\n\x12GetCommRankRequest\x12\x13\n\x0bworker_host\x18\x01 \x01(\t\x12\x15\n\x06job_id\x18\x02 \x01(\x05R\x05jobId"k\n\x13GetCommRankResponse\x12\x0f\n\x07rank_id\x18\x01 \x01(\x05\x12\x12\n\nworld_size\x18\x02 \x01(\x05\x12\x15\n\rrendezvous_id\x18\x03 \x01(\x03\x12\x18\n\x10coordinator_addr\x18\x04 \x01(\t"|\n\x1cReportTrainLoopStatusRequest\x12\x13\n\x0bworker_host\x18\x01 \x01(\t\x120\n\x06status\x18\x02 \x01(\x0e2 .elasticdl_tpu.TrainLoopStatusPB\x12\x15\n\x06job_id\x18\x03 \x01(\x05R\x05jobId"\xbe\x02\n\x1eReportEvaluationMetricsRequest\x12V\n\rmodel_outputs\x18\x01 \x03(\x0b2?.elasticdl_tpu.ReportEvaluationMetricsRequest.ModelOutputsEntry\x12\'\n\x06labels\x18\x02 \x01(\x0b2\x17.elasticdl_tpu.TensorPB\x12\x11\n\tworker_id\x18\x03 \x01(\x05\x12#\n\rmodel_version\x18\x04 \x01(\x05R\x0cmodelVersion\x12\x15\n\x06job_id\x18\x05 \x01(\x05R\x05jobId\x1aL\n\x11ModelOutputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12&\n\x05value\x18\x02 \x01(\x0b2\x17.elasticdl_tpu.TensorPB:\x028\x01"\xb7\x01\n\x14ReportVersionRequest\x12\x15\n\rmodel_version\x18\x01 \x01(\x05\x12\x13\n\x05is_ps\x18\x02 \x01(\x08R\x04isPs\x12\x13\n\x05ps_id\x18\x03 \x01(\x05R\x04psId\x12\x1e\n\ngeneration\x18\x04 \x01(\x03R\ngeneration\x12\'\n\x0fdurable_version\x18\x05 \x01(\x05R\x0edurableVersion\x12\x15\n\x06job_id\x18\x06 \x01(\x05R\x05jobId"\xa7\x01\n\x1bReportTrainingParamsRequest\x12\x12\n\nbatch_size\x18\x01 \x01(\x05\x12\x12\n\nnum_epochs\x18\x02 \x01(\x05\x12\x14\n\x0cdataset_size\x18\x03 \x01(\x03\x12\x0f\n\x07shuffle\x18\x04 \x01(\x08\x12\x16\n\x0eshuffle_shards\x18\x05 \x01(\x08\x12!\n\x19num_minibatches_per_shard\x18\x06 \x01(\x05"\x07\n\x05Empty"M\n\x1aPullDenseParametersRequest\x12\x0f\n\x07version\x18\x01 \x01(\x05\x12\x1e\n\ngeneration\x18\x02 \x01(\x03R\ngeneration"\xb4\x02\n\x1bPullDenseParametersResponse\x12\x13\n\x0binitialized\x18\x01 \x01(\x08\x12\x0f\n\x07version\x18\x02 \x01(\x05\x12Y\n\x10dense_parameters\x18\x03 \x03(\x0b2?.elasticdl_tpu.PullDenseParametersResponse.DenseParametersEntry\x12\x1e\n\ngeneration\x18\x04 \x01(\x03R\ngeneration\x12#\n\rframe_capable\x18\x05 \x01(\x08R\x0cframeCapable\x1aO\n\x14DenseParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12&\n\x05value\x18\x02 \x01(\x0b2\x17.elasticdl_tpu.TensorPB:\x028\x01"t\n\x1bPullEmbeddingVectorsRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0b\n\x03ids\x18\x02 \x03(\x03\x12\x1d\n\nwire_dtype\x18\x03 \x01(\tR\twireDtype\x12\x1b\n\tread_only\x18\x04 \x01(\x08R\x08readOnly"x\n\x14PushGradientsRequest\x12)\n\tgradients\x18\x01 \x01(\x0b2\x16.elasticdl_tpu.ModelPB\x12\x15\n\rlearning_rate\x18\x02 \x01(\x02\x12\x1e\n\ngeneration\x18\x03 \x01(\x03R\ngeneration"Z\n\x15PushGradientsResponse\x12\x10\n\x08accepted\x18\x01 \x01(\x08\x12\x0f\n\x07version\x18\x02 \x01(\x05\x12\x1e\n\ngeneration\x18\x03 \x01(\x03R\ngeneration"\x8b\x01\n\x17PrepareGradientsRequest\x12\x0e\n\x06txn_id\x18\x01 \x01(\t\x12)\n\tgradients\x18\x02 \x01(\x0b2\x16.elasticdl_tpu.ModelPB\x12\x15\n\rlearning_rate\x18\x03 \x01(\x02\x12\x1e\n\ngeneration\x18\x04 \x01(\x03R\ngeneration"8\n\x16CommitGradientsRequest\x12\x0e\n\x06txn_id\x18\x01 \x01(\t\x12\x0e\n\x06commit\x18\x02 \x01(\x08*\\\n\nTaskTypePB\x12\x0c\n\x08TRAINING\x10\x00\x12\x0e\n\nEVALUATION\x10\x01\x12\x0e\n\nPREDICTION\x10\x02\x12\x08\n\x04WAIT\x10\x03\x12\x16\n\x12TRAIN_END_CALLBACK\x10\x04*C\n\x11TrainLoopStatusPB\x12\x0e\n\nLOOP_START\x10\x00\x12\x0c\n\x08LOOP_END\x10\x01\x12\x10\n\x0cLOOP_PENDING\x10\x02b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'elastic_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MODELPB_DENSEPARAMETERSENTRY._options = None
  _MODELPB_DENSEPARAMETERSENTRY._serialized_options = b'8\001'
  _MODELPB_EMBEDDINGTABLESENTRY._options = None
  _MODELPB_EMBEDDINGTABLESENTRY._serialized_options = b'8\001'
  _REPORTTASKRESULTREQUEST_EXECCOUNTERSENTRY._options = None
  _REPORTTASKRESULTREQUEST_EXECCOUNTERSENTRY._serialized_options = b'8\001'
  _REPORTEVALUATIONMETRICSREQUEST_MODELOUTPUTSENTRY._options = None
  _REPORTEVALUATIONMETRICSREQUEST_MODELOUTPUTSENTRY._serialized_options = b'8\001'
  _PULLDENSEPARAMETERSRESPONSE_DENSEPARAMETERSENTRY._options = None
  _PULLDENSEPARAMETERSRESPONSE_DENSEPARAMETERSENTRY._serialized_options = b'8\001'
  _TENSORPB._serialized_start=32
  _TENSORPB._serialized_end=151
  _INDEXEDSLICESPB._serialized_start=153
  _INDEXEDSLICESPB._serialized_end=224
  _EMBEDDINGTABLEINFOPB._serialized_start=226
  _EMBEDDINGTABLEINFOPB._serialized_end=311
  _MODELPB._serialized_start=314
  _MODELPB._serialized_end=719
  _MODELPB_DENSEPARAMETERSENTRY._serialized_start=552
  _MODELPB_DENSEPARAMETERSENTRY._serialized_end=631
  _MODELPB_EMBEDDINGTABLESENTRY._serialized_start=633
  _MODELPB_EMBEDDINGTABLESENTRY._serialized_end=719
  _SHARDPB._serialized_start=721
  _SHARDPB._serialized_end=796
  _TASKPB._serialized_start=799
  _TASKPB._serialized_end=945
  _GETTASKREQUEST._serialized_start=947
  _GETTASKREQUEST._serialized_end=1051
  _GETTASKRESPONSE._serialized_start=1053
  _GETTASKRESPONSE._serialized_end=1161
  _REPORTTASKRESULTREQUEST._serialized_start=1164
  _REPORTTASKRESULTREQUEST._serialized_end=1401
  _REPORTTASKRESULTREQUEST_EXECCOUNTERSENTRY._serialized_start=1350
  _REPORTTASKRESULTREQUEST_EXECCOUNTERSENTRY._serialized_end=1401
  _REPORTBATCHDONEREQUEST._serialized_start=1404
  _REPORTBATCHDONEREQUEST._serialized_end=1699
  _GETCOMMRANKREQUEST._serialized_start=1701
  _GETCOMMRANKREQUEST._serialized_end=1765
  _GETCOMMRANKRESPONSE._serialized_start=1767
  _GETCOMMRANKRESPONSE._serialized_end=1874
  _REPORTTRAINLOOPSTATUSREQUEST._serialized_start=1876
  _REPORTTRAINLOOPSTATUSREQUEST._serialized_end=2000
  _REPORTEVALUATIONMETRICSREQUEST._serialized_start=2003
  _REPORTEVALUATIONMETRICSREQUEST._serialized_end=2321
  _REPORTEVALUATIONMETRICSREQUEST_MODELOUTPUTSENTRY._serialized_start=2245
  _REPORTEVALUATIONMETRICSREQUEST_MODELOUTPUTSENTRY._serialized_end=2321
  _REPORTVERSIONREQUEST._serialized_start=2324
  _REPORTVERSIONREQUEST._serialized_end=2507
  _REPORTTRAININGPARAMSREQUEST._serialized_start=2510
  _REPORTTRAININGPARAMSREQUEST._serialized_end=2677
  _EMPTY._serialized_start=2679
  _EMPTY._serialized_end=2686
  _PULLDENSEPARAMETERSREQUEST._serialized_start=2688
  _PULLDENSEPARAMETERSREQUEST._serialized_end=2765
  _PULLDENSEPARAMETERSRESPONSE._serialized_start=2768
  _PULLDENSEPARAMETERSRESPONSE._serialized_end=3076
  _PULLDENSEPARAMETERSRESPONSE_DENSEPARAMETERSENTRY._serialized_start=552
  _PULLDENSEPARAMETERSRESPONSE_DENSEPARAMETERSENTRY._serialized_end=631
  _PULLEMBEDDINGVECTORSREQUEST._serialized_start=3078
  _PULLEMBEDDINGVECTORSREQUEST._serialized_end=3194
  _PUSHGRADIENTSREQUEST._serialized_start=3196
  _PUSHGRADIENTSREQUEST._serialized_end=3316
  _PUSHGRADIENTSRESPONSE._serialized_start=3318
  _PUSHGRADIENTSRESPONSE._serialized_end=3408
  _PREPAREGRADIENTSREQUEST._serialized_start=3411
  _PREPAREGRADIENTSREQUEST._serialized_end=3550
  _COMMITGRADIENTSREQUEST._serialized_start=3552
  _COMMITGRADIENTSREQUEST._serialized_end=3608
  _TASKTYPEPB._serialized_start=3610
  _TASKTYPEPB._serialized_end=3702
  _TRAINLOOPSTATUSPB._serialized_start=3704
  _TRAINLOOPSTATUSPB._serialized_end=3771
# @@protoc_insertion_point(module_scope)
