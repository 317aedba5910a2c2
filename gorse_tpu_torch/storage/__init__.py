"""gorse_tpu_torch.storage (port of gorse_tpu.storage): the data, cache,
meta and blob stores and their types.

The proxy stores are exported here as the reference's package exports them,
loaded at first use (storage/proxy.py imports the vector store, and with it
the top-k kernels' wrappers).
"""

from .blob import BlobStore
from .cache import CacheStore, MemoryCacheStore, SQLiteCacheStore, open_cache_store
from .data import DataStore, MemoryDataStore, SQLiteDataStore, open_data_store
from .meta import MetaStore, Node
from .object import AzureBlobClient, GCSClient, ObjectBlobStore, S3Client, open_blob_store
from .types import Feedback, Item, Score, TimeSeriesPoint, User

_PROXY = ("ProxyCacheStore", "ProxyDataStore", "ProxyVectorStore", "add_storage_proxy")

__all__ = [
    "AzureBlobClient",
    "BlobStore",
    "GCSClient",
    "ObjectBlobStore",
    "S3Client",
    "open_blob_store",
    "ProxyCacheStore",
    "ProxyDataStore",
    "ProxyVectorStore",
    "add_storage_proxy",
    "CacheStore",
    "MemoryCacheStore",
    "SQLiteCacheStore",
    "open_cache_store",
    "DataStore",
    "MemoryDataStore",
    "SQLiteDataStore",
    "open_data_store",
    "MetaStore",
    "Node",
    "Feedback",
    "Item",
    "Score",
    "TimeSeriesPoint",
    "User",
]


def __getattr__(name: str):
    if name in _PROXY:
        from . import proxy

        return getattr(proxy, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
