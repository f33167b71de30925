# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: master.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cmaster.proto\x12\x0cswtpu.master\"\xa3\x02\n\x18VolumeInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x0c\n\x04size\x18\x02 \x01(\x04\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x12\n\nfile_count\x18\x04 \x01(\x04\x12\x14\n\x0c\x64\x65lete_count\x18\x05 \x01(\x04\x12\x1a\n\x12\x64\x65leted_byte_count\x18\x06 \x01(\x04\x12\x11\n\tread_only\x18\x07 \x01(\x08\x12\x19\n\x11replica_placement\x18\x08 \x01(\r\x12\x0f\n\x07version\x18\t \x01(\r\x12\x0b\n\x03ttl\x18\n \x01(\r\x12\x18\n\x10\x63ompact_revision\x18\x0b \x01(\r\x12\x1a\n\x12modified_at_second\x18\x0c \x01(\x03\x12\x11\n\tdisk_type\x18\r \x01(\t\"\x8b\x01\n\x1dVolumeShortInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x19\n\x11replica_placement\x18\x08 \x01(\r\x12\x0f\n\x07version\x18\t \x01(\r\x12\x0b\n\x03ttl\x18\n \x01(\r\x12\x11\n\tdisk_type\x18\r \x01(\t\"\x81\x01\n\x1fVolumeEcShardInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x15\n\rec_index_bits\x18\x03 \x01(\r\x12\x11\n\tdisk_type\x18\x04 \x01(\t\x12\x14\n\x0c\x64\x65stroy_time\x18\x05 \x01(\x03\"\xcb\x05\n\tHeartbeat\x12\n\n\x02ip\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\r\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\x12\x12\n\npublic_url\x18\x04 \x01(\t\x12\x14\n\x0cmax_file_key\x18\x05 \x01(\x04\x12\x13\n\x0b\x64\x61ta_center\x18\x06 \x01(\t\x12\x0c\n\x04rack\x18\x07 \x01(\t\x12G\n\x11max_volume_counts\x18\x08 \x03(\x0b\x32,.swtpu.master.Heartbeat.MaxVolumeCountsEntry\x12\x16\n\x0ehas_no_volumes\x18\t \x01(\x08\x12\x18\n\x10has_no_ec_shards\x18\n \x01(\x08\x12\x37\n\x07volumes\x18\x0b \x03(\x0b\x32&.swtpu.master.VolumeInformationMessage\x12@\n\x0bnew_volumes\x18\x0c \x03(\x0b\x32+.swtpu.master.VolumeShortInformationMessage\x12\x44\n\x0f\x64\x65leted_volumes\x18\r \x03(\x0b\x32+.swtpu.master.VolumeShortInformationMessage\x12@\n\tec_shards\x18\x0e \x03(\x0b\x32-.swtpu.master.VolumeEcShardInformationMessage\x12\x44\n\rnew_ec_shards\x18\x0f \x03(\x0b\x32-.swtpu.master.VolumeEcShardInformationMessage\x12H\n\x11\x64\x65leted_ec_shards\x18\x10 \x03(\x0b\x32-.swtpu.master.VolumeEcShardInformationMessage\x1a\x36\n\x14MaxVolumeCountsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\r:\x02\x38\x01\"\xb1\x01\n\x11HeartbeatResponse\x12\x19\n\x11volume_size_limit\x18\x01 \x01(\x04\x12\x0e\n\x06leader\x18\x02 \x01(\t\x12\x17\n\x0fmetrics_address\x18\x03 \x01(\t\x12 \n\x18metrics_interval_seconds\x18\x04 \x01(\r\x12\x36\n\x10storage_backends\x18\x05 \x03(\x0b\x32\x1c.swtpu.master.StorageBackend\"\x9f\x01\n\x0eStorageBackend\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\t\x12@\n\nproperties\x18\x03 \x03(\x0b\x32,.swtpu.master.StorageBackend.PropertiesEntry\x1a\x31\n\x0fPropertiesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"g\n\x14KeepConnectedRequest\x12\x13\n\x0b\x63lient_type\x18\x01 \x01(\t\x12\x16\n\x0e\x63lient_address\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\t\x12\x11\n\tgrpc_port\x18\x04 \x01(\r\"\xbf\x01\n\x0eVolumeLocation\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x10\n\x08new_vids\x18\x03 \x03(\r\x12\x14\n\x0c\x64\x65leted_vids\x18\x04 \x03(\r\x12\x0e\n\x06leader\x18\x05 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x06 \x01(\t\x12\x11\n\tgrpc_port\x18\x07 \x01(\r\x12\x13\n\x0bnew_ec_vids\x18\x08 \x03(\r\x12\x17\n\x0f\x64\x65leted_ec_vids\x18\t \x03(\r\"^\n\x11\x43lusterNodeUpdate\x12\x11\n\tnode_type\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\x0e\n\x06is_add\x18\x03 \x01(\x08\x12\x15\n\rcreated_at_ns\x18\x04 \x01(\x03\"\x8c\x01\n\x15KeepConnectedResponse\x12\x35\n\x0fvolume_location\x18\x01 \x01(\x0b\x32\x1c.swtpu.master.VolumeLocation\x12<\n\x13\x63luster_node_update\x18\x02 \x01(\x0b\x32\x1f.swtpu.master.ClusterNodeUpdate\"E\n\x13LookupVolumeRequest\x12\x1a\n\x12volume_or_file_ids\x18\x01 \x03(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\"\xdf\x01\n\x14LookupVolumeResponse\x12P\n\x13volume_id_locations\x18\x01 \x03(\x0b\x32\x33.swtpu.master.LookupVolumeResponse.VolumeIdLocation\x1au\n\x10VolumeIdLocation\x12\x19\n\x11volume_or_file_id\x18\x01 \x01(\t\x12)\n\tlocations\x18\x02 \x03(\x0b\x32\x16.swtpu.master.Location\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x0c\n\x04\x61uth\x18\x04 \x01(\t\"S\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\x12\x13\n\x0b\x64\x61ta_center\x18\x04 \x01(\t\"\xbc\x01\n\rAssignRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x04\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\x12\x0c\n\x04rack\x18\x06 \x01(\t\x12\x11\n\tdata_node\x18\x07 \x01(\t\x12\x1d\n\x15writable_volume_count\x18\x08 \x01(\r\x12\x11\n\tdisk_type\x18\t \x01(\t\"\x9d\x01\n\x0e\x41ssignResponse\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\x04\x12\r\n\x05\x65rror\x18\x05 \x01(\t\x12(\n\x08location\x18\x06 \x01(\x0b\x32\x16.swtpu.master.Location\x12\x0c\n\x04\x61uth\x18\x07 \x01(\t\x12(\n\x08replicas\x18\x08 \x03(\x0b\x32\x16.swtpu.master.Location\"\\\n\x11StatisticsRequest\x12\x13\n\x0breplication\x18\x01 \x01(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\x12\x11\n\tdisk_type\x18\x04 \x01(\t\"O\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x04 \x01(\x04\x12\x11\n\tused_size\x18\x05 \x01(\x04\x12\x12\n\nfile_count\x18\x06 \x01(\x04\"\x1e\n\x0e\x43ollectionInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\"S\n\x15\x43ollectionListRequest\x12\x1e\n\x16include_normal_volumes\x18\x01 \x01(\x08\x12\x1a\n\x12include_ec_volumes\x18\x02 \x01(\x08\"K\n\x16\x43ollectionListResponse\x12\x31\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x1c.swtpu.master.CollectionInfo\"\'\n\x17\x43ollectionDeleteRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x1a\n\x18\x43ollectionDeleteResponse\"\xa2\x02\n\x08\x44iskInfo\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x14\n\x0cvolume_count\x18\x02 \x01(\x03\x12\x18\n\x10max_volume_count\x18\x03 \x01(\x03\x12\x19\n\x11\x66ree_volume_count\x18\x04 \x01(\x03\x12\x1b\n\x13\x61\x63tive_volume_count\x18\x05 \x01(\x03\x12<\n\x0cvolume_infos\x18\x06 \x03(\x0b\x32&.swtpu.master.VolumeInformationMessage\x12\x45\n\x0e\x65\x63_shard_infos\x18\x07 \x03(\x0b\x32-.swtpu.master.VolumeEcShardInformationMessage\x12\x1b\n\x13remote_volume_count\x18\x08 \x01(\x03\"\xb6\x01\n\x0c\x44\x61taNodeInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12=\n\ndisk_infos\x18\x02 \x03(\x0b\x32).swtpu.master.DataNodeInfo.DiskInfosEntry\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\x1aH\n\x0e\x44iskInfosEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.swtpu.master.DiskInfo:\x02\x38\x01\"K\n\x08RackInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x33\n\x0f\x64\x61ta_node_infos\x18\x02 \x03(\x0b\x32\x1a.swtpu.master.DataNodeInfo\"H\n\x0e\x44\x61taCenterInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12*\n\nrack_infos\x18\x02 \x03(\x0b\x32\x16.swtpu.master.RackInfo\"S\n\x0cTopologyInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x37\n\x11\x64\x61ta_center_infos\x18\x02 \x03(\x0b\x32\x1c.swtpu.master.DataCenterInfo\"\x13\n\x11VolumeListRequest\"e\n\x12VolumeListResponse\x12\x31\n\rtopology_info\x18\x01 \x01(\x0b\x32\x1a.swtpu.master.TopologyInfo\x12\x1c\n\x14volume_size_limit_mb\x18\x02 \x01(\x04\"\x16\n\x14\x45\x63\x43ollectListRequest\",\n\x15\x45\x63\x43ollectListResponse\x12\x13\n\x0b\x63ollections\x18\x01 \x03(\t\"\"\n VolumeListWithoutECVolumeRequest\"*\n\x15LookupEcVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\xd1\x01\n\x16LookupEcVolumeResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12R\n\x12shard_id_locations\x18\x02 \x03(\x0b\x32\x36.swtpu.master.LookupEcVolumeResponse.EcShardIdLocation\x1aP\n\x11\x45\x63ShardIdLocation\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12)\n\tlocations\x18\x02 \x03(\x0b\x32\x16.swtpu.master.Location\"W\n\x13VacuumVolumeRequest\x12\x19\n\x11garbage_threshold\x18\x01 \x01(\x02\x12\x11\n\tvolume_id\x18\x02 \x01(\r\x12\x12\n\ncollection\x18\x03 \x01(\t\"\x16\n\x14VacuumVolumeResponse\"\x1f\n\x1dGetMasterConfigurationRequest\"\xfb\x01\n\x1eGetMasterConfigurationResponse\x12\x17\n\x0fmetrics_address\x18\x01 \x01(\t\x12 \n\x18metrics_interval_seconds\x18\x02 \x01(\r\x12\x36\n\x10storage_backends\x18\x03 \x03(\x0b\x32\x1c.swtpu.master.StorageBackend\x12\x1b\n\x13\x64\x65\x66\x61ult_replication\x18\x04 \x01(\t\x12\x0e\n\x06leader\x18\x05 \x01(\t\x12\x1d\n\x15volume_size_limit_m_b\x18\x06 \x01(\r\x12\x1a\n\x12volume_preallocate\x18\x07 \x01(\x08\"2\n\x0bPingRequest\x12\x0e\n\x06target\x18\x01 \x01(\t\x12\x13\n\x0btarget_type\x18\x02 \x01(\t\"S\n\x0cPingResponse\x12\x15\n\rstart_time_ns\x18\x01 \x01(\x03\x12\x16\n\x0eremote_time_ns\x18\x02 \x01(\x03\x12\x14\n\x0cstop_time_ns\x18\x03 \x01(\x03\"\x85\x01\n\x16LeaseAdminTokenRequest\x12\x16\n\x0eprevious_token\x18\x01 \x01(\x03\x12\x1a\n\x12previous_lock_time\x18\x02 \x01(\x03\x12\x11\n\tlock_name\x18\x03 \x01(\t\x12\x13\n\x0b\x63lient_name\x18\x04 \x01(\t\x12\x0f\n\x07message\x18\x05 \x01(\t\"<\n\x17LeaseAdminTokenResponse\x12\r\n\x05token\x18\x01 \x01(\x03\x12\x12\n\nlock_ts_ns\x18\x02 \x01(\x03\"a\n\x18ReleaseAdminTokenRequest\x12\x16\n\x0eprevious_token\x18\x01 \x01(\x03\x12\x1a\n\x12previous_lock_time\x18\x02 \x01(\x03\x12\x11\n\tlock_name\x18\x03 \x01(\t\"\x1b\n\x19ReleaseAdminTokenResponse\"\x16\n\x14\x44isableVacuumRequest\"\x17\n\x15\x44isableVacuumResponse\"\x15\n\x13\x45nableVacuumRequest\"\x16\n\x14\x45nableVacuumResponse\"B\n\x14RaftAddServerRequest\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\r\n\x05voter\x18\x03 \x01(\x08\"\x17\n\x15RaftAddServerResponse\"4\n\x17RaftRemoveServerRequest\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05\x66orce\x18\x02 \x01(\x08\"\x1a\n\x18RaftRemoveServerResponse\"\x1f\n\x1dRaftListClusterServersRequest\"\xc8\x01\n\x1eRaftListClusterServersResponse\x12S\n\x0f\x63luster_servers\x18\x01 \x03(\x0b\x32:.swtpu.master.RaftListClusterServersResponse.ClusterServer\x1aQ\n\rClusterServer\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\x11\n\tis_leader\x18\x03 \x01(\x08\x12\x10\n\x08suffrage\x18\x04 \x01(\t\"-\n\x0cRaftLogEntry\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0f\n\x07\x63ommand\x18\x02 \x01(\x0c\"d\n\x12RequestVoteRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x11\n\tcandidate\x18\x02 \x01(\t\x12\x16\n\x0elast_log_index\x18\x03 \x01(\x03\x12\x15\n\rlast_log_term\x18\x04 \x01(\x04\"4\n\x13RequestVoteResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0f\n\x07granted\x18\x02 \x01(\x08\"\xa7\x01\n\x14\x41ppendEntriesRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0e\n\x06leader\x18\x02 \x01(\t\x12\x16\n\x0eprev_log_index\x18\x03 \x01(\x03\x12\x15\n\rprev_log_term\x18\x04 \x01(\x04\x12+\n\x07\x65ntries\x18\x05 \x03(\x0b\x32\x1a.swtpu.master.RaftLogEntry\x12\x15\n\rleader_commit\x18\x06 \x01(\x03\"6\n\x15\x41ppendEntriesResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0f\n\x07success\x18\x02 \x01(\x08\".\n\x17ListClusterNodesRequest\x12\x13\n\x0b\x63lient_type\x18\x01 \x01(\t\"\xc0\x01\n\x18ListClusterNodesResponse\x12I\n\rcluster_nodes\x18\x01 \x03(\x0b\x32\x32.swtpu.master.ListClusterNodesResponse.ClusterNode\x1aY\n\x0b\x43lusterNode\x12\x0f\n\x07\x61\x64\x64ress\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x15\n\rcreated_at_ns\x18\x03 \x01(\x03\x12\x11\n\tgrpc_port\x18\x04 \x01(\rb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'master_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._options = None
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._serialized_options = b'8\001'
  _STORAGEBACKEND_PROPERTIESENTRY._options = None
  _STORAGEBACKEND_PROPERTIESENTRY._serialized_options = b'8\001'
  _DATANODEINFO_DISKINFOSENTRY._options = None
  _DATANODEINFO_DISKINFOSENTRY._serialized_options = b'8\001'
  _VOLUMEINFORMATIONMESSAGE._serialized_start=31
  _VOLUMEINFORMATIONMESSAGE._serialized_end=322
  _VOLUMESHORTINFORMATIONMESSAGE._serialized_start=325
  _VOLUMESHORTINFORMATIONMESSAGE._serialized_end=464
  _VOLUMEECSHARDINFORMATIONMESSAGE._serialized_start=467
  _VOLUMEECSHARDINFORMATIONMESSAGE._serialized_end=596
  _HEARTBEAT._serialized_start=599
  _HEARTBEAT._serialized_end=1314
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._serialized_start=1260
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._serialized_end=1314
  _HEARTBEATRESPONSE._serialized_start=1317
  _HEARTBEATRESPONSE._serialized_end=1494
  _STORAGEBACKEND._serialized_start=1497
  _STORAGEBACKEND._serialized_end=1656
  _STORAGEBACKEND_PROPERTIESENTRY._serialized_start=1607
  _STORAGEBACKEND_PROPERTIESENTRY._serialized_end=1656
  _KEEPCONNECTEDREQUEST._serialized_start=1658
  _KEEPCONNECTEDREQUEST._serialized_end=1761
  _VOLUMELOCATION._serialized_start=1764
  _VOLUMELOCATION._serialized_end=1955
  _CLUSTERNODEUPDATE._serialized_start=1957
  _CLUSTERNODEUPDATE._serialized_end=2051
  _KEEPCONNECTEDRESPONSE._serialized_start=2054
  _KEEPCONNECTEDRESPONSE._serialized_end=2194
  _LOOKUPVOLUMEREQUEST._serialized_start=2196
  _LOOKUPVOLUMEREQUEST._serialized_end=2265
  _LOOKUPVOLUMERESPONSE._serialized_start=2268
  _LOOKUPVOLUMERESPONSE._serialized_end=2491
  _LOOKUPVOLUMERESPONSE_VOLUMEIDLOCATION._serialized_start=2374
  _LOOKUPVOLUMERESPONSE_VOLUMEIDLOCATION._serialized_end=2491
  _LOCATION._serialized_start=2493
  _LOCATION._serialized_end=2576
  _ASSIGNREQUEST._serialized_start=2579
  _ASSIGNREQUEST._serialized_end=2767
  _ASSIGNRESPONSE._serialized_start=2770
  _ASSIGNRESPONSE._serialized_end=2927
  _STATISTICSREQUEST._serialized_start=2929
  _STATISTICSREQUEST._serialized_end=3021
  _STATISTICSRESPONSE._serialized_start=3023
  _STATISTICSRESPONSE._serialized_end=3102
  _COLLECTIONINFO._serialized_start=3104
  _COLLECTIONINFO._serialized_end=3134
  _COLLECTIONLISTREQUEST._serialized_start=3136
  _COLLECTIONLISTREQUEST._serialized_end=3219
  _COLLECTIONLISTRESPONSE._serialized_start=3221
  _COLLECTIONLISTRESPONSE._serialized_end=3296
  _COLLECTIONDELETEREQUEST._serialized_start=3298
  _COLLECTIONDELETEREQUEST._serialized_end=3337
  _COLLECTIONDELETERESPONSE._serialized_start=3339
  _COLLECTIONDELETERESPONSE._serialized_end=3365
  _DISKINFO._serialized_start=3368
  _DISKINFO._serialized_end=3658
  _DATANODEINFO._serialized_start=3661
  _DATANODEINFO._serialized_end=3843
  _DATANODEINFO_DISKINFOSENTRY._serialized_start=3771
  _DATANODEINFO_DISKINFOSENTRY._serialized_end=3843
  _RACKINFO._serialized_start=3845
  _RACKINFO._serialized_end=3920
  _DATACENTERINFO._serialized_start=3922
  _DATACENTERINFO._serialized_end=3994
  _TOPOLOGYINFO._serialized_start=3996
  _TOPOLOGYINFO._serialized_end=4079
  _VOLUMELISTREQUEST._serialized_start=4081
  _VOLUMELISTREQUEST._serialized_end=4100
  _VOLUMELISTRESPONSE._serialized_start=4102
  _VOLUMELISTRESPONSE._serialized_end=4203
  _ECCOLLECTLISTREQUEST._serialized_start=4205
  _ECCOLLECTLISTREQUEST._serialized_end=4227
  _ECCOLLECTLISTRESPONSE._serialized_start=4229
  _ECCOLLECTLISTRESPONSE._serialized_end=4273
  _VOLUMELISTWITHOUTECVOLUMEREQUEST._serialized_start=4275
  _VOLUMELISTWITHOUTECVOLUMEREQUEST._serialized_end=4309
  _LOOKUPECVOLUMEREQUEST._serialized_start=4311
  _LOOKUPECVOLUMEREQUEST._serialized_end=4353
  _LOOKUPECVOLUMERESPONSE._serialized_start=4356
  _LOOKUPECVOLUMERESPONSE._serialized_end=4565
  _LOOKUPECVOLUMERESPONSE_ECSHARDIDLOCATION._serialized_start=4485
  _LOOKUPECVOLUMERESPONSE_ECSHARDIDLOCATION._serialized_end=4565
  _VACUUMVOLUMEREQUEST._serialized_start=4567
  _VACUUMVOLUMEREQUEST._serialized_end=4654
  _VACUUMVOLUMERESPONSE._serialized_start=4656
  _VACUUMVOLUMERESPONSE._serialized_end=4678
  _GETMASTERCONFIGURATIONREQUEST._serialized_start=4680
  _GETMASTERCONFIGURATIONREQUEST._serialized_end=4711
  _GETMASTERCONFIGURATIONRESPONSE._serialized_start=4714
  _GETMASTERCONFIGURATIONRESPONSE._serialized_end=4965
  _PINGREQUEST._serialized_start=4967
  _PINGREQUEST._serialized_end=5017
  _PINGRESPONSE._serialized_start=5019
  _PINGRESPONSE._serialized_end=5102
  _LEASEADMINTOKENREQUEST._serialized_start=5105
  _LEASEADMINTOKENREQUEST._serialized_end=5238
  _LEASEADMINTOKENRESPONSE._serialized_start=5240
  _LEASEADMINTOKENRESPONSE._serialized_end=5300
  _RELEASEADMINTOKENREQUEST._serialized_start=5302
  _RELEASEADMINTOKENREQUEST._serialized_end=5399
  _RELEASEADMINTOKENRESPONSE._serialized_start=5401
  _RELEASEADMINTOKENRESPONSE._serialized_end=5428
  _DISABLEVACUUMREQUEST._serialized_start=5430
  _DISABLEVACUUMREQUEST._serialized_end=5452
  _DISABLEVACUUMRESPONSE._serialized_start=5454
  _DISABLEVACUUMRESPONSE._serialized_end=5477
  _ENABLEVACUUMREQUEST._serialized_start=5479
  _ENABLEVACUUMREQUEST._serialized_end=5500
  _ENABLEVACUUMRESPONSE._serialized_start=5502
  _ENABLEVACUUMRESPONSE._serialized_end=5524
  _RAFTADDSERVERREQUEST._serialized_start=5526
  _RAFTADDSERVERREQUEST._serialized_end=5592
  _RAFTADDSERVERRESPONSE._serialized_start=5594
  _RAFTADDSERVERRESPONSE._serialized_end=5617
  _RAFTREMOVESERVERREQUEST._serialized_start=5619
  _RAFTREMOVESERVERREQUEST._serialized_end=5671
  _RAFTREMOVESERVERRESPONSE._serialized_start=5673
  _RAFTREMOVESERVERRESPONSE._serialized_end=5699
  _RAFTLISTCLUSTERSERVERSREQUEST._serialized_start=5701
  _RAFTLISTCLUSTERSERVERSREQUEST._serialized_end=5732
  _RAFTLISTCLUSTERSERVERSRESPONSE._serialized_start=5735
  _RAFTLISTCLUSTERSERVERSRESPONSE._serialized_end=5935
  _RAFTLISTCLUSTERSERVERSRESPONSE_CLUSTERSERVER._serialized_start=5854
  _RAFTLISTCLUSTERSERVERSRESPONSE_CLUSTERSERVER._serialized_end=5935
  _RAFTLOGENTRY._serialized_start=5937
  _RAFTLOGENTRY._serialized_end=5982
  _REQUESTVOTEREQUEST._serialized_start=5984
  _REQUESTVOTEREQUEST._serialized_end=6084
  _REQUESTVOTERESPONSE._serialized_start=6086
  _REQUESTVOTERESPONSE._serialized_end=6138
  _APPENDENTRIESREQUEST._serialized_start=6141
  _APPENDENTRIESREQUEST._serialized_end=6308
  _APPENDENTRIESRESPONSE._serialized_start=6310
  _APPENDENTRIESRESPONSE._serialized_end=6364
  _LISTCLUSTERNODESREQUEST._serialized_start=6366
  _LISTCLUSTERNODESREQUEST._serialized_end=6412
  _LISTCLUSTERNODESRESPONSE._serialized_start=6415
  _LISTCLUSTERNODESRESPONSE._serialized_end=6607
  _LISTCLUSTERNODESRESPONSE_CLUSTERNODE._serialized_start=6518
  _LISTCLUSTERNODESRESPONSE_CLUSTERNODE._serialized_end=6607
# @@protoc_insertion_point(module_scope)
