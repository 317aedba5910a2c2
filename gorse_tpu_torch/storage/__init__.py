"""gorse_tpu_torch.storage (port of gorse_tpu.storage).

The proxy stores are exported here as the reference's package exports them,
loaded at first use (storage/proxy.py imports the three store modules).
"""

_PROXY = ("ProxyCacheStore", "ProxyDataStore", "ProxyVectorStore", "add_storage_proxy")


def __getattr__(name: str):
    if name in _PROXY:
        from . import proxy

        return getattr(proxy, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
