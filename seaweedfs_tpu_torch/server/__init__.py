"""The volume server of the port: its core (`volume_server`, no grpcio or
protobuf) and its gRPC binding (`grpc_service`)."""
