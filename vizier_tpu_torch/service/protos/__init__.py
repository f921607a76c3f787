"""The port's generated protobuf message modules.

Copies of the JAX package's four message schemas under ``package
vizier_tpu_torch``, generated by ``build.sh`` from the repository root: the
files register as ``vizier_tpu_torch/service/protos/*.proto`` and import one
another by package path (no ``sys.path`` entry, no flat top-level modules),
so both packages' protos load in one process. Every message, enum, field
name, number, type and label equals the JAX package's, so a message
serialized by one package parses in the other.
"""

from vizier_tpu_torch.service.protos import key_value_pb2
from vizier_tpu_torch.service.protos import pythia_service_pb2
from vizier_tpu_torch.service.protos import study_pb2
from vizier_tpu_torch.service.protos import vizier_service_pb2

__all__ = ["key_value_pb2", "pythia_service_pb2", "study_pb2", "vizier_service_pb2"]
