# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: mount.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bmount.proto\x12\x08mount_pb\"/\n\x10\x43onfigureRequest\x12\x1b\n\x13\x63ollection_capacity\x18\x01 \x01(\x03\"?\n\x11\x43onfigureResponse\x12\x1b\n\x13\x63ollection_capacity\x18\x01 \x01(\x03\x12\r\n\x05\x65rror\x18\x02 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mount_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CONFIGUREREQUEST._serialized_start=25
  _CONFIGUREREQUEST._serialized_end=72
  _CONFIGURERESPONSE._serialized_start=74
  _CONFIGURERESPONSE._serialized_end=137
# @@protoc_insertion_point(module_scope)
