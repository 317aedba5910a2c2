"""Blob-store openers (port of ``open_blob_store`` and
``open_blob_store_from_config`` of gorse_tpu/storage/object.py).

A plain path or a ``file://`` URL opens the POSIX :class:`BlobStore`. The
reference's object-store backends (``s3://``, ``gs://``/``gcs://``,
``azblob://``: stdlib REST clients with a local spool) are not ported; their
URLs raise ``NotImplementedError`` (ROADMAP.md, M21).
"""

from __future__ import annotations

from .blob import BlobStore

_NOT_PORTED = ("s3", "gs", "gcs", "azblob")


def open_blob_store(url: str) -> BlobStore:
    """Open a blob store by URL: a plain path or ``file://<path>``."""
    if "://" not in url or url.startswith("file://"):
        return BlobStore(url[len("file://"):] if url.startswith("file://") else url)
    scheme = url.split("://", 1)[0]
    if scheme in _NOT_PORTED:
        raise NotImplementedError(
            f"blob store {scheme!r} is not ported yet: ROADMAP.md M21 (the remote blob backends)"
        )
    raise ValueError(f"unsupported blob store URL {url!r}")


def open_blob_store_from_config(blob_cfg, override: str = "", fallback: str = "") -> BlobStore:
    """Open the blob store of a ``[blob]`` config section: ``override``
    (``database.blob_store``) wins over ``[blob].uri``, and ``fallback``
    applies when neither is set, as in the reference."""
    return open_blob_store(override or blob_cfg.uri or fallback)
