# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: s3.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x08s3.proto\x12\x05s3_pb\"\xd5\x01\n\x16S3CircuitBreakerConfig\x12.\n\x06global\x18\x01 \x01(\x0b\x32\x1e.s3_pb.S3CircuitBreakerOptions\x12;\n\x07\x62uckets\x18\x02 \x03(\x0b\x32*.s3_pb.S3CircuitBreakerConfig.BucketsEntry\x1aN\n\x0c\x42ucketsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12-\n\x05value\x18\x02 \x01(\x0b\x32\x1e.s3_pb.S3CircuitBreakerOptions:\x02\x38\x01\"\x98\x01\n\x17S3CircuitBreakerOptions\x12\x0f\n\x07\x65nabled\x18\x01 \x01(\x08\x12<\n\x07\x61\x63tions\x18\x02 \x03(\x0b\x32+.s3_pb.S3CircuitBreakerOptions.ActionsEntry\x1a.\n\x0c\x41\x63tionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 's3_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _S3CIRCUITBREAKERCONFIG_BUCKETSENTRY._options = None
  _S3CIRCUITBREAKERCONFIG_BUCKETSENTRY._serialized_options = b'8\001'
  _S3CIRCUITBREAKEROPTIONS_ACTIONSENTRY._options = None
  _S3CIRCUITBREAKEROPTIONS_ACTIONSENTRY._serialized_options = b'8\001'
  _S3CIRCUITBREAKERCONFIG._serialized_start=20
  _S3CIRCUITBREAKERCONFIG._serialized_end=233
  _S3CIRCUITBREAKERCONFIG_BUCKETSENTRY._serialized_start=155
  _S3CIRCUITBREAKERCONFIG_BUCKETSENTRY._serialized_end=233
  _S3CIRCUITBREAKEROPTIONS._serialized_start=236
  _S3CIRCUITBREAKEROPTIONS._serialized_end=388
  _S3CIRCUITBREAKEROPTIONS_ACTIONSENTRY._serialized_start=342
  _S3CIRCUITBREAKEROPTIONS_ACTIONSENTRY._serialized_end=388
# @@protoc_insertion_point(module_scope)
