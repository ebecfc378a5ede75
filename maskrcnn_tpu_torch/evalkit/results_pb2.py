# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: results.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rresults.proto\"\x95\x03\n\x06Result\x12$\n\timageInfo\x18\x01 \x01(\x0b\x32\x11.Result.ImageInfo\x12%\n\ndetections\x18\x02 \x03(\x0b\x32\x11.Result.Detection\x1a\x1e\n\x06Origin\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x1a%\n\x04Size\x12\r\n\x05width\x18\x01 \x01(\x01\x12\x0e\n\x06height\x18\x02 \x01(\x01\x1a\x42\n\x04Rect\x12\x1e\n\x06origin\x18\x01 \x01(\x0b\x32\x0e.Result.Origin\x12\x1a\n\x04size\x18\x02 \x01(\x0b\x32\x0c.Result.Size\x1aI\n\tImageInfo\x12\x11\n\tdatasetID\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\t\x12\r\n\x05width\x18\x03 \x01(\x05\x12\x0e\n\x06height\x18\x04 \x01(\x05\x1ah\n\tDetection\x12\x13\n\x0bprobability\x18\x01 \x01(\x01\x12\x0f\n\x07\x63lassID\x18\x02 \x01(\x05\x12\x12\n\nclassLabel\x18\x03 \x01(\t\x12!\n\x0b\x62oundingBox\x18\x04 \x01(\x0b\x32\x0c.Result.Rect\"#\n\x07Results\x12\x18\n\x07results\x18\x01 \x03(\x0b\x32\x07.Resultb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'results_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RESULT._serialized_start=18
  _RESULT._serialized_end=423
  _RESULT_ORIGIN._serialized_start=105
  _RESULT_ORIGIN._serialized_end=135
  _RESULT_SIZE._serialized_start=137
  _RESULT_SIZE._serialized_end=174
  _RESULT_RECT._serialized_start=176
  _RESULT_RECT._serialized_end=242
  _RESULT_IMAGEINFO._serialized_start=244
  _RESULT_IMAGEINFO._serialized_end=317
  _RESULT_DETECTION._serialized_start=319
  _RESULT_DETECTION._serialized_end=423
  _RESULTS._serialized_start=425
  _RESULTS._serialized_end=460
# @@protoc_insertion_point(module_scope)
