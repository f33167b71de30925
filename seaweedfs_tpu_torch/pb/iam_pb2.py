# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: iam.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tiam.proto\x12\x06iam_pb\":\n\x12S3ApiConfiguration\x12$\n\nidentities\x18\x01 \x03(\x0b\x32\x10.iam_pb.Identity\"t\n\x08Identity\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\'\n\x0b\x63redentials\x18\x02 \x03(\x0b\x32\x12.iam_pb.Credential\x12\x0f\n\x07\x61\x63tions\x18\x03 \x03(\t\x12 \n\x07\x61\x63\x63ount\x18\x04 \x01(\x0b\x32\x0f.iam_pb.Account\"2\n\nCredential\x12\x11\n\taccessKey\x18\x01 \x01(\t\x12\x11\n\tsecretKey\x18\x02 \x01(\t\"@\n\x07\x41\x63\x63ount\x12\n\n\x02id\x18\x01 \x01(\t\x12\x13\n\x0b\x64isplayName\x18\x02 \x01(\t\x12\x14\n\x0c\x65mailAddress\x18\x03 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'iam_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _S3APICONFIGURATION._serialized_start=21
  _S3APICONFIGURATION._serialized_end=79
  _IDENTITY._serialized_start=81
  _IDENTITY._serialized_end=197
  _CREDENTIAL._serialized_start=199
  _CREDENTIAL._serialized_end=249
  _ACCOUNT._serialized_start=251
  _ACCOUNT._serialized_end=315
# @@protoc_insertion_point(module_scope)
