# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: mq.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x08mq.proto\x12\x08swtpu.mq\"(\n\x05Topic\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"]\n\tPartition\x12\x11\n\tring_size\x18\x01 \x01(\x05\x12\x13\n\x0brange_start\x18\x02 \x01(\x05\x12\x12\n\nrange_stop\x18\x03 \x01(\x05\x12\x14\n\x0cunix_time_ns\x18\x04 \x01(\x03\"e\n\x15\x43onfigureTopicRequest\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\x12\x17\n\x0fpartition_count\x18\x02 \x01(\x05\x12\x13\n\x0brecord_type\x18\x03 \x01(\x0c\"R\n\x16\x43onfigureTopicResponse\x12\x38\n\x0b\x61ssignments\x18\x01 \x03(\x0b\x32#.swtpu.mq.BrokerPartitionAssignment\">\n\x1cGetTopicConfigurationRequest\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\"\xa7\x01\n\x1dGetTopicConfigurationResponse\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\x12\x17\n\x0fpartition_count\x18\x02 \x01(\x05\x12\x13\n\x0brecord_type\x18\x03 \x01(\x0c\x12\x38\n\x0b\x61ssignments\x18\x04 \x03(\x0b\x32#.swtpu.mq.BrokerPartitionAssignment\"Z\n\x19\x42rokerPartitionAssignment\x12&\n\tpartition\x18\x01 \x01(\x0b\x32\x13.swtpu.mq.Partition\x12\x15\n\rleader_broker\x18\x02 \x01(\t\";\n\x19LookupTopicBrokersRequest\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\"v\n\x1aLookupTopicBrokersResponse\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\x12\x38\n\x0b\x61ssignments\x18\x02 \x03(\x0b\x32#.swtpu.mq.BrokerPartitionAssignment\"\x13\n\x11ListTopicsRequest\"5\n\x12ListTopicsResponse\x12\x1f\n\x06topics\x18\x01 \x03(\x0b\x32\x0f.swtpu.mq.Topic\"8\n\x0b\x44\x61taMessage\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\r\n\x05ts_ns\x18\x03 \x01(\x03\"\xd8\x01\n\x0ePublishRequest\x12\x32\n\x04init\x18\x01 \x01(\x0b\x32$.swtpu.mq.PublishRequest.InitMessage\x12#\n\x04\x64\x61ta\x18\x02 \x01(\x0b\x32\x15.swtpu.mq.DataMessage\x1am\n\x0bInitMessage\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\x12&\n\tpartition\x18\x02 \x01(\x0b\x32\x13.swtpu.mq.Partition\x12\x16\n\x0epublisher_name\x18\x03 \x01(\t\"6\n\x0fPublishResponse\x12\x14\n\x0c\x61\x63k_sequence\x18\x01 \x01(\x03\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\xf3\x01\n\x10SubscribeRequest\x12\x34\n\x04init\x18\x01 \x01(\x0b\x32&.swtpu.mq.SubscribeRequest.InitMessage\x1a\xa8\x01\n\x0bInitMessage\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\x12&\n\tpartition\x18\x02 \x01(\x0b\x32\x13.swtpu.mq.Partition\x12\x16\n\x0e\x63onsumer_group\x18\x03 \x01(\t\x12\x13\n\x0b\x63onsumer_id\x18\x04 \x01(\t\x12\x14\n\x0cstart_offset\x18\x05 \x01(\x03\x12\x0e\n\x06\x66ollow\x18\x06 \x01(\x08\"b\n\x11SubscribeResponse\x12#\n\x04\x64\x61ta\x18\x01 \x01(\x0b\x32\x15.swtpu.mq.DataMessage\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x18\n\x10is_end_of_stream\x18\x03 \x01(\x08\"\x16\n\x14\x42\x61lanceTopicsRequest\"\xb9\x01\n\x15\x42\x61lanceTopicsResponse\x12\x44\n\x0b\x61ssignments\x18\x01 \x03(\x0b\x32/.swtpu.mq.BalanceTopicsResponse.TopicAssignment\x1aZ\n\x0fTopicAssignment\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\x12\'\n\npartitions\x18\x02 \x03(\x0b\x32\x13.swtpu.mq.Partition\"\r\n\x0bPingRequest\"&\n\x0cPingResponse\x12\x16\n\x0eremote_time_ns\x18\x01 \x01(\x03\"P\n\x16\x46indCoordinatorRequest\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\x12\x16\n\x0e\x63onsumer_group\x18\x02 \x01(\t\".\n\x17\x46indCoordinatorResponse\x12\x13\n\x0b\x63oordinator\x18\x01 \x01(\t\"\xdf\x02\n!SubscriberToSubCoordinatorRequest\x12\x45\n\x04init\x18\x01 \x01(\x0b\x32\x37.swtpu.mq.SubscriberToSubCoordinatorRequest.InitMessage\x12\x43\n\x03\x61\x63k\x18\x02 \x01(\x0b\x32\x36.swtpu.mq.SubscriberToSubCoordinatorRequest.AckMessage\x1ai\n\x0bInitMessage\x12\x16\n\x0e\x63onsumer_group\x18\x01 \x01(\t\x12\"\n\x1a\x63onsumer_group_instance_id\x18\x02 \x01(\t\x12\x1e\n\x05topic\x18\x03 \x01(\x0b\x32\x0f.swtpu.mq.Topic\x1a\x43\n\nAckMessage\x12&\n\tpartition\x18\x01 \x01(\x0b\x32\x13.swtpu.mq.Partition\x12\r\n\x05ts_ns\x18\x02 \x01(\x03\"\xd7\x01\n\"SubscriberToSubCoordinatorResponse\x12K\n\nassignment\x18\x01 \x01(\x0b\x32\x37.swtpu.mq.SubscriberToSubCoordinatorResponse.Assignment\x1a\x64\n\nAssignment\x12\x12\n\ngeneration\x18\x01 \x01(\x03\x12\x42\n\x15partition_assignments\x18\x02 \x03(\x0b\x32#.swtpu.mq.BrokerPartitionAssignment\"?\n\x1d\x44\x65scribeConsumerGroupsRequest\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\"\xaf\x03\n\x1e\x44\x65scribeConsumerGroupsResponse\x12>\n\x06groups\x18\x01 \x03(\x0b\x32..swtpu.mq.DescribeConsumerGroupsResponse.Group\x1a\x46\n\x06Member\x12\x13\n\x0binstance_id\x18\x01 \x01(\t\x12\'\n\npartitions\x18\x02 \x03(\x0b\x32\x13.swtpu.mq.Partition\x1aL\n\x0fPartitionOffset\x12&\n\tpartition\x18\x01 \x01(\x0b\x32\x13.swtpu.mq.Partition\x12\x11\n\tcommitted\x18\x02 \x01(\x03\x1a\xb6\x01\n\x05Group\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x12\n\ngeneration\x18\x02 \x01(\x03\x12@\n\x07members\x18\x03 \x03(\x0b\x32/.swtpu.mq.DescribeConsumerGroupsResponse.Member\x12I\n\x07offsets\x18\x04 \x03(\x0b\x32\x38.swtpu.mq.DescribeConsumerGroupsResponse.PartitionOffset\"\x85\x01\n\x13\x43ommitOffsetRequest\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\x12&\n\tpartition\x18\x02 \x01(\x0b\x32\x13.swtpu.mq.Partition\x12\x16\n\x0e\x63onsumer_group\x18\x03 \x01(\t\x12\x0e\n\x06offset\x18\x04 \x01(\x03\"%\n\x14\x43ommitOffsetResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"t\n\x12\x46\x65tchOffsetRequest\x12\x1e\n\x05topic\x18\x01 \x01(\x0b\x32\x0f.swtpu.mq.Topic\x12&\n\tpartition\x18\x02 \x01(\x0b\x32\x13.swtpu.mq.Partition\x12\x16\n\x0e\x63onsumer_group\x18\x03 \x01(\t\"4\n\x13\x46\x65tchOffsetResponse\x12\x0e\n\x06offset\x18\x01 \x01(\x03\x12\r\n\x05\x66ound\x18\x02 \x01(\x08\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mq_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TOPIC._serialized_start=22
  _TOPIC._serialized_end=62
  _PARTITION._serialized_start=64
  _PARTITION._serialized_end=157
  _CONFIGURETOPICREQUEST._serialized_start=159
  _CONFIGURETOPICREQUEST._serialized_end=260
  _CONFIGURETOPICRESPONSE._serialized_start=262
  _CONFIGURETOPICRESPONSE._serialized_end=344
  _GETTOPICCONFIGURATIONREQUEST._serialized_start=346
  _GETTOPICCONFIGURATIONREQUEST._serialized_end=408
  _GETTOPICCONFIGURATIONRESPONSE._serialized_start=411
  _GETTOPICCONFIGURATIONRESPONSE._serialized_end=578
  _BROKERPARTITIONASSIGNMENT._serialized_start=580
  _BROKERPARTITIONASSIGNMENT._serialized_end=670
  _LOOKUPTOPICBROKERSREQUEST._serialized_start=672
  _LOOKUPTOPICBROKERSREQUEST._serialized_end=731
  _LOOKUPTOPICBROKERSRESPONSE._serialized_start=733
  _LOOKUPTOPICBROKERSRESPONSE._serialized_end=851
  _LISTTOPICSREQUEST._serialized_start=853
  _LISTTOPICSREQUEST._serialized_end=872
  _LISTTOPICSRESPONSE._serialized_start=874
  _LISTTOPICSRESPONSE._serialized_end=927
  _DATAMESSAGE._serialized_start=929
  _DATAMESSAGE._serialized_end=985
  _PUBLISHREQUEST._serialized_start=988
  _PUBLISHREQUEST._serialized_end=1204
  _PUBLISHREQUEST_INITMESSAGE._serialized_start=1095
  _PUBLISHREQUEST_INITMESSAGE._serialized_end=1204
  _PUBLISHRESPONSE._serialized_start=1206
  _PUBLISHRESPONSE._serialized_end=1260
  _SUBSCRIBEREQUEST._serialized_start=1263
  _SUBSCRIBEREQUEST._serialized_end=1506
  _SUBSCRIBEREQUEST_INITMESSAGE._serialized_start=1338
  _SUBSCRIBEREQUEST_INITMESSAGE._serialized_end=1506
  _SUBSCRIBERESPONSE._serialized_start=1508
  _SUBSCRIBERESPONSE._serialized_end=1606
  _BALANCETOPICSREQUEST._serialized_start=1608
  _BALANCETOPICSREQUEST._serialized_end=1630
  _BALANCETOPICSRESPONSE._serialized_start=1633
  _BALANCETOPICSRESPONSE._serialized_end=1818
  _BALANCETOPICSRESPONSE_TOPICASSIGNMENT._serialized_start=1728
  _BALANCETOPICSRESPONSE_TOPICASSIGNMENT._serialized_end=1818
  _PINGREQUEST._serialized_start=1820
  _PINGREQUEST._serialized_end=1833
  _PINGRESPONSE._serialized_start=1835
  _PINGRESPONSE._serialized_end=1873
  _FINDCOORDINATORREQUEST._serialized_start=1875
  _FINDCOORDINATORREQUEST._serialized_end=1955
  _FINDCOORDINATORRESPONSE._serialized_start=1957
  _FINDCOORDINATORRESPONSE._serialized_end=2003
  _SUBSCRIBERTOSUBCOORDINATORREQUEST._serialized_start=2006
  _SUBSCRIBERTOSUBCOORDINATORREQUEST._serialized_end=2357
  _SUBSCRIBERTOSUBCOORDINATORREQUEST_INITMESSAGE._serialized_start=2183
  _SUBSCRIBERTOSUBCOORDINATORREQUEST_INITMESSAGE._serialized_end=2288
  _SUBSCRIBERTOSUBCOORDINATORREQUEST_ACKMESSAGE._serialized_start=2290
  _SUBSCRIBERTOSUBCOORDINATORREQUEST_ACKMESSAGE._serialized_end=2357
  _SUBSCRIBERTOSUBCOORDINATORRESPONSE._serialized_start=2360
  _SUBSCRIBERTOSUBCOORDINATORRESPONSE._serialized_end=2575
  _SUBSCRIBERTOSUBCOORDINATORRESPONSE_ASSIGNMENT._serialized_start=2475
  _SUBSCRIBERTOSUBCOORDINATORRESPONSE_ASSIGNMENT._serialized_end=2575
  _DESCRIBECONSUMERGROUPSREQUEST._serialized_start=2577
  _DESCRIBECONSUMERGROUPSREQUEST._serialized_end=2640
  _DESCRIBECONSUMERGROUPSRESPONSE._serialized_start=2643
  _DESCRIBECONSUMERGROUPSRESPONSE._serialized_end=3074
  _DESCRIBECONSUMERGROUPSRESPONSE_MEMBER._serialized_start=2741
  _DESCRIBECONSUMERGROUPSRESPONSE_MEMBER._serialized_end=2811
  _DESCRIBECONSUMERGROUPSRESPONSE_PARTITIONOFFSET._serialized_start=2813
  _DESCRIBECONSUMERGROUPSRESPONSE_PARTITIONOFFSET._serialized_end=2889
  _DESCRIBECONSUMERGROUPSRESPONSE_GROUP._serialized_start=2892
  _DESCRIBECONSUMERGROUPSRESPONSE_GROUP._serialized_end=3074
  _COMMITOFFSETREQUEST._serialized_start=3077
  _COMMITOFFSETREQUEST._serialized_end=3210
  _COMMITOFFSETRESPONSE._serialized_start=3212
  _COMMITOFFSETRESPONSE._serialized_end=3249
  _FETCHOFFSETREQUEST._serialized_start=3251
  _FETCHOFFSETREQUEST._serialized_end=3367
  _FETCHOFFSETRESPONSE._serialized_start=3369
  _FETCHOFFSETRESPONSE._serialized_end=3421
# @@protoc_insertion_point(module_scope)
