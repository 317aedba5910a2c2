"""The Master and BlobStore gRPC services and their clients (port of
gorse_tpu/protocol/rpc.py).

As gorse's protocol.proto services (Master: GetMeta, PushProgress;
BlobStore: Upload, Download, List) and their clients (worker/worker.go):
node registration and meta distribution, progress pushes, and model
artifacts streamed in 1 MiB chunks for deployments whose nodes share no file
system or object store. The services run on protocol/grpcwire.py's server
with its generic handlers, the messages are protocol/pb.py's.
"""

from __future__ import annotations

import logging
import socket
from pathlib import Path

from . import grpcwire
from . import pb
from .. import __version__

logger = logging.getLogger(__name__)

def _safe_relpath(filename: str) -> str:
    """Reject absolute or parent-escaping file paths inside a blob (both the
    Upload RPC and the download client consume peer-supplied filenames;
    without this an Upload chunk with filename=../../x writes outside the
    blob store)."""
    from pathlib import PurePosixPath, PureWindowsPath

    if not filename or filename != filename.strip():
        raise ValueError(f"invalid blob filename {filename!r}")
    pp = PurePosixPath(filename)
    if pp.is_absolute() or PureWindowsPath(filename).is_absolute():
        raise ValueError(f"absolute blob filename {filename!r}")
    if any(part in ("..", "") for part in pp.parts):
        raise ValueError(f"blob filename escapes blob directory: {filename!r}")
    return filename


CHUNK_SIZE = 1 << 20  # 1 MiB chunks (reference streams model blobs in chunks)

_MASTER = "gorse_tpu.Master"
_BLOB = "gorse_tpu.BlobStore"


def serve_master_grpc(
    master,
    blob_store,
    host: str = "127.0.0.1",
    port: int = 0,
    tls=None,
    data_store=None,
    cache_store=None,
    vector_store=None,
) -> tuple[grpcwire.Server, int]:
    """Register the Master and BlobStore services on a new gRPC server.

    ``master`` is serve.master.Master; ``blob_store`` is storage.blob.BlobStore.
    Returns (server, bound_port). With ``tls`` (utils.tls.TLSConfig) the port
    is mutually-authenticated (reference: master/master.go:374-383). Passing
    ``data_store``/``cache_store``/``vector_store`` additionally registers the
    storage proxy service (reference: master/master.go:391-393) so other nodes
    can reach master-local stores via ``proxy://`` URLs.
    """

    def get_meta(request: pb.NodeInfo, context) -> pb.Meta:
        # register/heartbeat the node (reference: master/rpc.go:30-40)
        if request.uuid:
            from ..storage.meta import Node

            master.meta.update_node(
                Node(
                    uuid=request.uuid,
                    hostname=request.hostname,
                    node_type=request.node_type or "worker",
                    version=request.version,
                )
            )
        meta = master.get_meta()
        return pb.Meta(
            config_json=meta["config"],
            cf_model_id=meta["cf_model_id"],
            ctr_model_id=meta["ctr_model_id"],
            servers=meta["servers"],
            workers=meta["workers"],
        )

    def push_progress(request: pb.Progress, context) -> pb.PushProgressResponse:
        spans = [
            {
                "Name": s.name,
                "Total": s.total,
                "Count": s.count,
                "Status": s.status,
                "StartTime": s.start_time,
                "FinishTime": s.finish_time,
                "Error": s.error,
            }
            for s in request.spans
        ]
        master.progress.push_remote(request.uuid, spans)
        return pb.PushProgressResponse()

    def upload(request_iterator, context) -> pb.UploadResponse:
        total = 0
        names: set[str] = set()
        started: set[tuple[str, str]] = set()
        for chunk in request_iterator:
            target = blob_store.create(chunk.name) / _safe_relpath(chunk.filename)
            target.parent.mkdir(parents=True, exist_ok=True)
            # first chunk of each file truncates; later chunks append
            key = (chunk.name, chunk.filename)
            mode = "ab" if key in started else "wb"
            started.add(key)
            names.add(chunk.name)
            with open(target, mode) as f:
                f.write(chunk.data)
            total += len(chunk.data)
        for name in names:
            blob_store.flush(name)  # object-store backends upload here
        return pb.UploadResponse(bytes_received=total)

    def download(request: pb.BlobRequest, context):
        blob_dir = blob_store.open(request.name)
        for path in sorted(Path(blob_dir).rglob("*")):
            if not path.is_file():
                continue
            rel = str(path.relative_to(blob_dir))
            with open(path, "rb") as f:
                while True:
                    data = f.read(CHUNK_SIZE)
                    if not data:
                        break
                    yield pb.BlobChunk(name=request.name, filename=rel, data=data)
            yield pb.BlobChunk(name=request.name, filename=rel, eof=True)

    def list_blobs(request: pb.BlobRequest, context) -> pb.BlobList:
        return pb.BlobList(names=blob_store.list())

    master_handlers = grpcwire.method_handlers_generic_handler(
        _MASTER,
        {
            "GetMeta": grpcwire.unary_unary_rpc_method_handler(
                get_meta,
                request_deserializer=pb.NodeInfo.FromString,
                response_serializer=pb.Meta.SerializeToString,
            ),
            "PushProgress": grpcwire.unary_unary_rpc_method_handler(
                push_progress,
                request_deserializer=pb.Progress.FromString,
                response_serializer=pb.PushProgressResponse.SerializeToString,
            ),
        },
    )
    blob_handlers = grpcwire.method_handlers_generic_handler(
        _BLOB,
        {
            "Upload": grpcwire.stream_unary_rpc_method_handler(
                upload,
                request_deserializer=pb.BlobChunk.FromString,
                response_serializer=pb.UploadResponse.SerializeToString,
            ),
            "Download": grpcwire.unary_stream_rpc_method_handler(
                download,
                request_deserializer=pb.BlobRequest.FromString,
                response_serializer=pb.BlobChunk.SerializeToString,
            ),
            "List": grpcwire.unary_unary_rpc_method_handler(
                list_blobs,
                request_deserializer=pb.BlobRequest.FromString,
                response_serializer=pb.BlobList.SerializeToString,
            ),
        },
    )
    # 512 MiB received (grpcwire's limit), no limit sent (gorse: worker/worker.go:361)
    server = grpcwire.Server(max_workers=8)
    server.add_generic_rpc_handlers((master_handlers, blob_handlers))
    if data_store is not None or cache_store is not None or vector_store is not None:
        from ..storage.proxy import add_storage_proxy

        add_storage_proxy(server, data=data_store, cache=cache_store, vectors=vector_store)
    from ..utils.tls import bind_port

    bound = bind_port(server, f"{host}:{port}", tls)
    if data_store is not None or cache_store is not None or vector_store is not None:
        # let GetMeta rewrite node-local store URLs to this proxy endpoint
        master.grpc_proxy_target = f"{host}:{bound}"
    server.start()
    logger.info("gRPC master listening on %s:%d", host, bound)
    return server, bound


class MasterGrpcClient:
    """gRPC MasterClient (reference: worker/worker.go grpc.Dial + GetMeta)."""

    def __init__(self, target: str, node_type: str = "worker", node_id: str | None = None, tls=None) -> None:
        import uuid as uuid_mod

        from ..utils.tls import make_channel

        self.channel = make_channel(target, tls)
        self.node_type = node_type
        self.node_id = node_id or f"{node_type}-{uuid_mod.uuid4().hex[:8]}"
        self._get_meta = self.channel.unary_unary(
            f"/{_MASTER}/GetMeta",
            request_serializer=pb.NodeInfo.SerializeToString,
            response_deserializer=pb.Meta.FromString,
        )
        self._push_progress = self.channel.unary_unary(
            f"/{_MASTER}/PushProgress",
            request_serializer=pb.Progress.SerializeToString,
            response_deserializer=pb.PushProgressResponse.FromString,
        )

    def get_meta(self) -> dict:
        meta = self._get_meta(
            pb.NodeInfo(
                uuid=self.node_id,
                hostname=socket.gethostname(),
                node_type=self.node_type,
                version=__version__,
            )
        )
        return {
            "config": meta.config_json,
            "cf_model_id": meta.cf_model_id,
            "ctr_model_id": meta.ctr_model_id,
            "servers": list(meta.servers),
            "workers": list(meta.workers),
        }

    def push_progress(self, spans: list[dict]) -> None:
        self._push_progress(
            pb.Progress(
                uuid=self.node_id,
                spans=[
                    pb.ProgressSpan(
                        name=s.get("Name", ""),
                        total=int(s.get("Total") or 0),
                        count=int(s.get("Count") or 0),
                        status=s.get("Status", ""),
                        start_time=float(s.get("StartTime") or 0.0),
                        finish_time=float(s.get("FinishTime") or 0.0),
                        error=s.get("Error", ""),
                    )
                    for s in spans
                ],
            )
        )

    def close(self) -> None:
        self.channel.close()


class BlobStoreClient:
    """Chunk-streamed blob transfer (reference: storage/blob/blob.go:86-290
    gRPC proxy path)."""

    def __init__(self, target: str, tls=None) -> None:
        from ..utils.tls import make_channel

        self.channel = make_channel(target, tls)
        self._upload = self.channel.stream_unary(
            f"/{_BLOB}/Upload",
            request_serializer=pb.BlobChunk.SerializeToString,
            response_deserializer=pb.UploadResponse.FromString,
        )
        self._download = self.channel.unary_stream(
            f"/{_BLOB}/Download",
            request_serializer=pb.BlobRequest.SerializeToString,
            response_deserializer=pb.BlobChunk.FromString,
        )
        self._list = self.channel.unary_unary(
            f"/{_BLOB}/List",
            request_serializer=pb.BlobRequest.SerializeToString,
            response_deserializer=pb.BlobList.FromString,
        )

    def upload(self, name: str, local_dir: str | Path) -> int:
        local_dir = Path(local_dir)

        def chunks():
            for path in sorted(local_dir.rglob("*")):
                if not path.is_file():
                    continue
                rel = str(path.relative_to(local_dir))
                sent_any = False
                with open(path, "rb") as f:
                    while True:
                        data = f.read(CHUNK_SIZE)
                        if not data:
                            break
                        sent_any = True
                        yield pb.BlobChunk(name=name, filename=rel, data=data)
                if not sent_any:  # zero-byte file still needs creating
                    yield pb.BlobChunk(name=name, filename=rel, data=b"")

        return self._upload(chunks()).bytes_received

    def download(self, name: str, local_dir: str | Path) -> Path:
        local_dir = Path(local_dir)
        local_dir.mkdir(parents=True, exist_ok=True)
        open_files: dict[str, object] = {}
        try:
            for chunk in self._download(pb.BlobRequest(name=name)):
                _safe_relpath(chunk.filename)  # reject traversal from the server
                if chunk.eof:
                    f = open_files.pop(chunk.filename, None)
                    if f:
                        f.close()
                    else:  # zero-byte file: only the eof chunk arrives
                        target = local_dir / chunk.filename
                        target.parent.mkdir(parents=True, exist_ok=True)
                        target.touch()
                    continue
                if chunk.filename not in open_files:
                    target = local_dir / chunk.filename
                    target.parent.mkdir(parents=True, exist_ok=True)
                    open_files[chunk.filename] = open(target, "wb")
                open_files[chunk.filename].write(chunk.data)
        finally:
            for f in open_files.values():
                f.close()
        return local_dir

    def list(self) -> list[str]:
        return list(self._list(pb.BlobRequest()).names)

    def close(self) -> None:
        self.channel.close()
