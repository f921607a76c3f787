#!/usr/bin/env bash
# Regenerates the port's protobuf message modules (messages only: the gRPC
# method tables are hand-written in vizier_tpu_torch/service/grpc_stubs.py).
#
# protoc runs from the repository root, so each file registers in protobuf's
# descriptor pool as vizier_tpu_torch/service/protos/<name>.proto under
# package vizier_tpu_torch, and the generated modules import one another as
# vizier_tpu_torch.service.protos.<name>_pb2: they load beside the JAX
# package's protos in one process.
set -euo pipefail
cd "$(dirname "$0")/../../.."
protoc --python_out=. \
  vizier_tpu_torch/service/protos/key_value.proto \
  vizier_tpu_torch/service/protos/study.proto \
  vizier_tpu_torch/service/protos/vizier_service.proto \
  vizier_tpu_torch/service/protos/pythia_service.proto
echo "Regenerated $(ls vizier_tpu_torch/service/protos/*_pb2.py | wc -l) message modules."
