"""The service layer of the port: datastores, servicers, servers, clients.

This package's ``__init__`` imports nothing, so the protobuf-free policy
factory (``service.policy_factory``) imports on a machine without ``grpc``
or ``protobuf``; the modules that need them (``protos``, the datastores,
the servicers, ``grpc_stubs``, ``vizier_server``, the clients) are imported
by name.
"""
