# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: filer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x66iler.proto\x12\x0bswtpu.filer\"=\n\x06\x46ileId\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08\x66ile_key\x18\x02 \x01(\x04\x12\x0e\n\x06\x63ookie\x18\x03 \x01(\x07\"\xa0\x01\n\tFileChunk\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\x16\n\x0emodified_ts_ns\x18\x04 \x01(\x03\x12\r\n\x05\x65_tag\x18\x05 \x01(\t\x12\x19\n\x11is_chunk_manifest\x18\x06 \x01(\x08\x12\x0e\n\x06\x63rc32c\x18\x07 \x01(\x07\x12\x12\n\ncipher_key\x18\x08 \x01(\x0c\";\n\x11\x46ileChunkManifest\x12&\n\x06\x63hunks\x18\x01 \x03(\x0b\x32\x16.swtpu.filer.FileChunk\"\xb4\x02\n\x0e\x46useAttributes\x12\x11\n\tfile_size\x18\x01 \x01(\x04\x12\r\n\x05mtime\x18\x02 \x01(\x03\x12\x11\n\tfile_mode\x18\x03 \x01(\r\x12\x0b\n\x03uid\x18\x04 \x01(\r\x12\x0b\n\x03gid\x18\x05 \x01(\r\x12\x0e\n\x06\x63rtime\x18\x06 \x01(\x03\x12\x0c\n\x04mime\x18\x07 \x01(\t\x12\x0f\n\x07ttl_sec\x18\x08 \x01(\x05\x12\x11\n\tuser_name\x18\t \x01(\t\x12\x13\n\x0bgroup_names\x18\n \x03(\t\x12\x16\n\x0esymlink_target\x18\x0b \x01(\t\x12\x0b\n\x03md5\x18\x0c \x01(\x0c\x12\x0c\n\x04rdev\x18\r \x01(\r\x12\r\n\x05inode\x18\x0e \x01(\x04\x12\x12\n\ncollection\x18\x0f \x01(\t\x12\x13\n\x0breplication\x18\x10 \x01(\t\x12\x11\n\tdisk_type\x18\x11 \x01(\t\"\xab\x02\n\x05\x45ntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0cis_directory\x18\x02 \x01(\x08\x12&\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x16.swtpu.filer.FileChunk\x12/\n\nattributes\x18\x04 \x01(\x0b\x32\x1b.swtpu.filer.FuseAttributes\x12\x32\n\x08\x65xtended\x18\x05 \x03(\x0b\x32 .swtpu.filer.Entry.ExtendedEntry\x12\x14\n\x0chard_link_id\x18\x06 \x01(\x0c\x12\x19\n\x11hard_link_counter\x18\x07 \x01(\x05\x12\x0f\n\x07\x63ontent\x18\x08 \x01(\x0c\x1a/\n\rExtendedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\";\n\tFullEntry\x12\x0b\n\x03\x64ir\x18\x01 \x01(\t\x12!\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x12.swtpu.filer.Entry\">\n\x1bLookupDirectoryEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"A\n\x1cLookupDirectoryEntryResponse\x12!\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x12.swtpu.filer.Entry\"\x82\x01\n\x12ListEntriesRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0e\n\x06prefix\x18\x02 \x01(\t\x12\x1c\n\x14start_from_file_name\x18\x03 \x01(\t\x12\x1c\n\x14inclusive_start_from\x18\x04 \x01(\x08\x12\r\n\x05limit\x18\x05 \x01(\r\"8\n\x13ListEntriesResponse\x12!\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x12.swtpu.filer.Entry\"\x8d\x01\n\x12\x43reateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12!\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x12.swtpu.filer.Entry\x12\x0e\n\x06o_excl\x18\x03 \x01(\x08\x12\x1d\n\x15is_from_other_cluster\x18\x04 \x01(\x08\x12\x12\n\nsignatures\x18\x05 \x03(\x05\"$\n\x13\x43reateEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"}\n\x12UpdateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12!\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x12.swtpu.filer.Entry\x12\x1d\n\x15is_from_other_cluster\x18\x03 \x01(\x08\x12\x12\n\nkeep_mtime\x18\x04 \x01(\x08\"\x15\n\x13UpdateEntryResponse\"e\n\x14\x41ppendToEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x12\n\nentry_name\x18\x02 \x01(\t\x12&\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x16.swtpu.filer.FileChunk\"\x17\n\x15\x41ppendToEntryResponse\"\xa2\x01\n\x12\x44\x65leteEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x16\n\x0eis_delete_data\x18\x03 \x01(\x08\x12\x14\n\x0cis_recursive\x18\x04 \x01(\x08\x12\x1e\n\x16ignore_recursive_error\x18\x05 \x01(\x08\x12\x1d\n\x15is_from_other_cluster\x18\x06 \x01(\x08\"$\n\x13\x44\x65leteEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"l\n\x18\x41tomicRenameEntryRequest\x12\x15\n\rold_directory\x18\x01 \x01(\t\x12\x10\n\x08old_name\x18\x02 \x01(\t\x12\x15\n\rnew_directory\x18\x03 \x01(\t\x12\x10\n\x08new_name\x18\x04 \x01(\t\"\x1b\n\x19\x41tomicRenameEntryResponse\"\x7f\n\x13\x41ssignVolumeRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x05\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0f\n\x07ttl_sec\x18\x04 \x01(\x05\x12\x11\n\tdisk_type\x18\x05 \x01(\t\x12\x0c\n\x04path\x18\x06 \x01(\t\"\xa6\x01\n\x14\x41ssignVolumeResponse\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x14\n\x0clocation_url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\x05\x12\r\n\x05\x65rror\x18\x05 \x01(\t\x12\x12\n\ncollection\x18\x06 \x01(\t\x12\x13\n\x0breplication\x18\x07 \x01(\t\x12\x0c\n\x04\x61uth\x18\x08 \x01(\t\"1\n\x13LookupVolumeRequest\x12\x1a\n\x12volume_or_file_ids\x18\x01 \x03(\t\"5\n\tLocations\x12(\n\tlocations\x18\x01 \x03(\x0b\x32\x15.swtpu.filer.Location\">\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\"\xaf\x01\n\x14LookupVolumeResponse\x12J\n\rlocations_map\x18\x01 \x03(\x0b\x32\x33.swtpu.filer.LookupVolumeResponse.LocationsMapEntry\x1aK\n\x11LocationsMapEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.swtpu.filer.Locations:\x02\x38\x01\"I\n\x11StatisticsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\"O\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x01 \x01(\x04\x12\x11\n\tused_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\"\x1e\n\x1cGetFilerConfigurationRequest\"\x8c\x01\n\x1dGetFilerConfigurationResponse\x12\x0f\n\x07masters\x18\x01 \x03(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0e\n\x06max_mb\x18\x04 \x01(\r\x12\x11\n\tsignature\x18\x05 \x01(\x05\x12\x0e\n\x06now_ns\x18\x06 \x01(\x03\"\x1b\n\x0cKvGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\"-\n\rKvGetResponse\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"*\n\x0cKvPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\"\x1e\n\rKvPutResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"d\n\x10LinkEntryRequest\x12\x15\n\rold_directory\x18\x01 \x01(\t\x12\x10\n\x08old_name\x18\x02 \x01(\t\x12\x15\n\rnew_directory\x18\x03 \x01(\t\x12\x10\n\x08new_name\x18\x04 \x01(\t\"\"\n\x11LinkEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"\xc4\x01\n\x11\x45ventNotification\x12%\n\told_entry\x18\x01 \x01(\x0b\x32\x12.swtpu.filer.Entry\x12%\n\tnew_entry\x18\x02 \x01(\x0b\x32\x12.swtpu.filer.Entry\x12\x15\n\rdelete_chunks\x18\x03 \x01(\x08\x12\x17\n\x0fnew_parent_path\x18\x04 \x01(\t\x12\x1d\n\x15is_from_other_cluster\x18\x05 \x01(\x08\x12\x12\n\nsignatures\x18\x06 \x03(\x05\"i\n\x18SubscribeMetadataRequest\x12\x13\n\x0b\x63lient_name\x18\x01 \x01(\t\x12\x13\n\x0bpath_prefix\x18\x02 \x01(\t\x12\x10\n\x08since_ns\x18\x03 \x01(\x03\x12\x11\n\tsignature\x18\x04 \x01(\x05\"y\n\x19SubscribeMetadataResponse\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12:\n\x12\x65vent_notification\x18\x02 \x01(\x0b\x32\x1e.swtpu.filer.EventNotification\x12\r\n\x05ts_ns\x18\x03 \x01(\x03\"(\n\x13PurgeMetaLogRequest\x12\x11\n\tbefore_ns\x18\x01 \x01(\x03\"&\n\x14PurgeMetaLogResponse\x12\x0e\n\x06purged\x18\x01 \x01(\x04\"2\n\x0bPingRequest\x12\x0e\n\x06target\x18\x01 \x01(\t\x12\x13\n\x0btarget_type\x18\x02 \x01(\t\"S\n\x0cPingResponse\x12\x15\n\rstart_time_ns\x18\x01 \x01(\x03\x12\x16\n\x0eremote_time_ns\x18\x02 \x01(\x03\x12\x14\n\x0cstop_time_ns\x18\x03 \x01(\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'filer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTRY_EXTENDEDENTRY._options = None
  _ENTRY_EXTENDEDENTRY._serialized_options = b'8\001'
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._options = None
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_options = b'8\001'
  _FILEID._serialized_start=28
  _FILEID._serialized_end=89
  _FILECHUNK._serialized_start=92
  _FILECHUNK._serialized_end=252
  _FILECHUNKMANIFEST._serialized_start=254
  _FILECHUNKMANIFEST._serialized_end=313
  _FUSEATTRIBUTES._serialized_start=316
  _FUSEATTRIBUTES._serialized_end=624
  _ENTRY._serialized_start=627
  _ENTRY._serialized_end=926
  _ENTRY_EXTENDEDENTRY._serialized_start=879
  _ENTRY_EXTENDEDENTRY._serialized_end=926
  _FULLENTRY._serialized_start=928
  _FULLENTRY._serialized_end=987
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_start=989
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_end=1051
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_start=1053
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_end=1118
  _LISTENTRIESREQUEST._serialized_start=1121
  _LISTENTRIESREQUEST._serialized_end=1251
  _LISTENTRIESRESPONSE._serialized_start=1253
  _LISTENTRIESRESPONSE._serialized_end=1309
  _CREATEENTRYREQUEST._serialized_start=1312
  _CREATEENTRYREQUEST._serialized_end=1453
  _CREATEENTRYRESPONSE._serialized_start=1455
  _CREATEENTRYRESPONSE._serialized_end=1491
  _UPDATEENTRYREQUEST._serialized_start=1493
  _UPDATEENTRYREQUEST._serialized_end=1618
  _UPDATEENTRYRESPONSE._serialized_start=1620
  _UPDATEENTRYRESPONSE._serialized_end=1641
  _APPENDTOENTRYREQUEST._serialized_start=1643
  _APPENDTOENTRYREQUEST._serialized_end=1744
  _APPENDTOENTRYRESPONSE._serialized_start=1746
  _APPENDTOENTRYRESPONSE._serialized_end=1769
  _DELETEENTRYREQUEST._serialized_start=1772
  _DELETEENTRYREQUEST._serialized_end=1934
  _DELETEENTRYRESPONSE._serialized_start=1936
  _DELETEENTRYRESPONSE._serialized_end=1972
  _ATOMICRENAMEENTRYREQUEST._serialized_start=1974
  _ATOMICRENAMEENTRYREQUEST._serialized_end=2082
  _ATOMICRENAMEENTRYRESPONSE._serialized_start=2084
  _ATOMICRENAMEENTRYRESPONSE._serialized_end=2111
  _ASSIGNVOLUMEREQUEST._serialized_start=2113
  _ASSIGNVOLUMEREQUEST._serialized_end=2240
  _ASSIGNVOLUMERESPONSE._serialized_start=2243
  _ASSIGNVOLUMERESPONSE._serialized_end=2409
  _LOOKUPVOLUMEREQUEST._serialized_start=2411
  _LOOKUPVOLUMEREQUEST._serialized_end=2460
  _LOCATIONS._serialized_start=2462
  _LOCATIONS._serialized_end=2515
  _LOCATION._serialized_start=2517
  _LOCATION._serialized_end=2579
  _LOOKUPVOLUMERESPONSE._serialized_start=2582
  _LOOKUPVOLUMERESPONSE._serialized_end=2757
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_start=2682
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_end=2757
  _STATISTICSREQUEST._serialized_start=2759
  _STATISTICSREQUEST._serialized_end=2832
  _STATISTICSRESPONSE._serialized_start=2834
  _STATISTICSRESPONSE._serialized_end=2913
  _GETFILERCONFIGURATIONREQUEST._serialized_start=2915
  _GETFILERCONFIGURATIONREQUEST._serialized_end=2945
  _GETFILERCONFIGURATIONRESPONSE._serialized_start=2948
  _GETFILERCONFIGURATIONRESPONSE._serialized_end=3088
  _KVGETREQUEST._serialized_start=3090
  _KVGETREQUEST._serialized_end=3117
  _KVGETRESPONSE._serialized_start=3119
  _KVGETRESPONSE._serialized_end=3164
  _KVPUTREQUEST._serialized_start=3166
  _KVPUTREQUEST._serialized_end=3208
  _KVPUTRESPONSE._serialized_start=3210
  _KVPUTRESPONSE._serialized_end=3240
  _LINKENTRYREQUEST._serialized_start=3242
  _LINKENTRYREQUEST._serialized_end=3342
  _LINKENTRYRESPONSE._serialized_start=3344
  _LINKENTRYRESPONSE._serialized_end=3378
  _EVENTNOTIFICATION._serialized_start=3381
  _EVENTNOTIFICATION._serialized_end=3577
  _SUBSCRIBEMETADATAREQUEST._serialized_start=3579
  _SUBSCRIBEMETADATAREQUEST._serialized_end=3684
  _SUBSCRIBEMETADATARESPONSE._serialized_start=3686
  _SUBSCRIBEMETADATARESPONSE._serialized_end=3807
  _PURGEMETALOGREQUEST._serialized_start=3809
  _PURGEMETALOGREQUEST._serialized_end=3849
  _PURGEMETALOGRESPONSE._serialized_start=3851
  _PURGEMETALOGRESPONSE._serialized_end=3889
  _PINGREQUEST._serialized_start=3891
  _PINGREQUEST._serialized_end=3941
  _PINGRESPONSE._serialized_start=3943
  _PINGRESPONSE._serialized_end=4026
# @@protoc_insertion_point(module_scope)
