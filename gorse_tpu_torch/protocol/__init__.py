"""The gRPC control plane (port of gorse_tpu/protocol/).

Messages are encoded by hand (pb.py), the services run on the port's own
gRPC over HTTP/2 (grpcwire.py over h2.py): no grpc and no protobuf. See
rpc.py for the Master and BlobStore services.
"""

from . import pb  # noqa: F401
from .rpc import BlobStoreClient, MasterGrpcClient, serve_master_grpc

__all__ = ["pb", "BlobStoreClient", "MasterGrpcClient", "serve_master_grpc"]
