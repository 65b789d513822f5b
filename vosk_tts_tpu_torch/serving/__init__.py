"""Serving: the dynamic batcher (batcher.py, needs neither grpc nor
protobuf), the gRPC server and client (server.py, client.py) and the
message classes (proto.py, built without protoc)."""
