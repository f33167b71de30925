# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: remote.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cremote.proto\x12\tremote_pb\"6\n\nRemoteConf\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0c\n\x04spec\x18\x03 \x01(\t\"C\n\x15RemoteStorageLocation\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06\x62ucket\x18\x02 \x01(\t\x12\x0c\n\x04path\x18\x03 \x01(\t\"\x9f\x01\n\x14RemoteStorageMapping\x12?\n\x08mappings\x18\x01 \x03(\x0b\x32-.remote_pb.RemoteStorageMapping.MappingsEntry\x1a\x46\n\rMappingsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12$\n\x05value\x18\x02 \x01(\x0b\x32\x15.remote_pb.MountEntry:\x02\x38\x01\"*\n\nMountEntry\x12\x0c\n\x04spec\x18\x01 \x01(\t\x12\x0e\n\x06prefix\x18\x02 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'remote_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._options = None
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._serialized_options = b'8\001'
  _REMOTECONF._serialized_start=27
  _REMOTECONF._serialized_end=81
  _REMOTESTORAGELOCATION._serialized_start=83
  _REMOTESTORAGELOCATION._serialized_end=150
  _REMOTESTORAGEMAPPING._serialized_start=153
  _REMOTESTORAGEMAPPING._serialized_end=312
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._serialized_start=242
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._serialized_end=312
  _MOUNTENTRY._serialized_start=314
  _MOUNTENTRY._serialized_end=356
# @@protoc_insertion_point(module_scope)
