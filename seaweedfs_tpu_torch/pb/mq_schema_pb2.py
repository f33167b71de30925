# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: mq_schema.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fmq_schema.proto\x12\x0cswtpu.schema\"1\n\nRecordType\x12#\n\x06\x66ields\x18\x01 \x03(\x0b\x32\x13.swtpu.schema.Field\"v\n\x05\x46ield\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x13\n\x0b\x66ield_index\x18\x02 \x01(\x05\x12 \n\x04type\x18\x03 \x01(\x0b\x32\x12.swtpu.schema.Type\x12\x13\n\x0bis_repeated\x18\x04 \x01(\x08\x12\x13\n\x0bis_required\x18\x05 \x01(\x08\"\x9d\x01\n\x04Type\x12/\n\x0bscalar_type\x18\x01 \x01(\x0e\x32\x18.swtpu.schema.ScalarTypeH\x00\x12/\n\x0brecord_type\x18\x02 \x01(\x0b\x32\x18.swtpu.schema.RecordTypeH\x00\x12+\n\tlist_type\x18\x03 \x01(\x0b\x32\x16.swtpu.schema.ListTypeH\x00\x42\x06\n\x04kind\"4\n\x08ListType\x12(\n\x0c\x65lement_type\x18\x01 \x01(\x0b\x32\x12.swtpu.schema.Type\"\x88\x01\n\x0bRecordValue\x12\x35\n\x06\x66ields\x18\x01 \x03(\x0b\x32%.swtpu.schema.RecordValue.FieldsEntry\x1a\x42\n\x0b\x46ieldsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.swtpu.schema.Value:\x02\x38\x01\"\x93\x02\n\x05Value\x12\x14\n\nbool_value\x18\x01 \x01(\x08H\x00\x12\x15\n\x0bint32_value\x18\x02 \x01(\x05H\x00\x12\x15\n\x0bint64_value\x18\x03 \x01(\x03H\x00\x12\x15\n\x0b\x66loat_value\x18\x04 \x01(\x02H\x00\x12\x16\n\x0c\x64ouble_value\x18\x05 \x01(\x01H\x00\x12\x15\n\x0b\x62ytes_value\x18\x06 \x01(\x0cH\x00\x12\x16\n\x0cstring_value\x18\x07 \x01(\tH\x00\x12-\n\nlist_value\x18\x0e \x01(\x0b\x32\x17.swtpu.schema.ListValueH\x00\x12\x31\n\x0crecord_value\x18\x0f \x01(\x0b\x32\x19.swtpu.schema.RecordValueH\x00\x42\x06\n\x04kind\"0\n\tListValue\x12#\n\x06values\x18\x01 \x03(\x0b\x32\x13.swtpu.schema.Value*Z\n\nScalarType\x12\x08\n\x04\x42OOL\x10\x00\x12\t\n\x05INT32\x10\x01\x12\t\n\x05INT64\x10\x03\x12\t\n\x05\x46LOAT\x10\x04\x12\n\n\x06\x44OUBLE\x10\x05\x12\t\n\x05\x42YTES\x10\x06\x12\n\n\x06STRING\x10\x07\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mq_schema_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RECORDVALUE_FIELDSENTRY._options = None
  _RECORDVALUE_FIELDSENTRY._serialized_options = b'8\001'
  _SCALARTYPE._serialized_start=885
  _SCALARTYPE._serialized_end=975
  _RECORDTYPE._serialized_start=33
  _RECORDTYPE._serialized_end=82
  _FIELD._serialized_start=84
  _FIELD._serialized_end=202
  _TYPE._serialized_start=205
  _TYPE._serialized_end=362
  _LISTTYPE._serialized_start=364
  _LISTTYPE._serialized_end=416
  _RECORDVALUE._serialized_start=419
  _RECORDVALUE._serialized_end=555
  _RECORDVALUE_FIELDSENTRY._serialized_start=489
  _RECORDVALUE_FIELDSENTRY._serialized_end=555
  _VALUE._serialized_start=558
  _VALUE._serialized_end=833
  _LISTVALUE._serialized_start=835
  _LISTVALUE._serialized_end=883
# @@protoc_insertion_point(module_scope)
