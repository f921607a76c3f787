"""The service layer of the port: the protobuf-free policy factory."""
