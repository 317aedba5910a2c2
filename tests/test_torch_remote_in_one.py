"""The whole slice on the CPU: the port's in-one node from a copy of
config.toml.example over the remote stores — ``mysql://`` data, ``redis://``
cache, ``s3://`` blobs (the port's own MiniMySQL, MiniRedis and MiniS3 on
127.0.0.1) and the ``hnsw://`` vector store — against the same node over
``sqlite://`` files, on the rows and cuts of tests/test_torch_in_one.py.
One cycle each, on one CPU thread (torch's multi-threaded CPU backward sums
in a varying order): every cache collection's content and every search key
equal, exactly; lists may differ only in the order of equal scores, which
each store returns in its own order (SQLite's ``ORDER BY score`` too). The
master's saved blobs read back from S3 byte for byte, and the item vectors
sit in the HNSW store."""

from pathlib import Path

import pytest
import torch
from test_torch_in_one import CUTS, N_USERS, _caches, _fill, _set

from gorse_tpu_torch.serve.in_one import InOneNode
from gorse_tpu_torch.serve.master import Master
from gorse_tpu_torch.storage import cache as ck
from gorse_tpu_torch.storage import types
from gorse_tpu_torch.storage.data import open_data_store
from gorse_tpu_torch.storage.miniobj import MiniS3
from gorse_tpu_torch.storage.minisql import MiniMySQL
from gorse_tpu_torch.storage.object import ObjectBlobStore
from gorse_tpu_torch.storage.resp import MiniRedis
from gorse_tpu_torch.storage.vectors import HNSWVectorStore
from gorse_tpu_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]


def _config(tmp: Path, stores: dict) -> Path:
    text = (ROOT / "config.toml.example").read_text()
    for (section, key), value in stores.items():
        text = _set(text, section, key, f'"{value}"')
    for section, key, value in CUTS:
        text = _set(text, section, key, value)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "config.toml").write_text(text)
    return tmp / "config.toml"


@pytest.fixture(scope="module")
def servers():
    mysql, s3, redis = MiniMySQL().start(), MiniS3().start(), MiniRedis()
    yield {"mysql": mysql, "s3": s3, "redis": redis}
    mysql.stop()
    s3.stop()
    redis.close()


def _cycle(tmp: Path, stores: dict):
    """One ``run_once`` of a node on ``stores`` after the rows went in
    through its own data store."""
    path = _config(tmp, stores)
    data = open_data_store(stores["database", "data_store"])
    _fill(data, types)
    data.close()
    node = InOneNode(load_config(path), workdir=str(tmp), device="cpu")
    return node, node.run_once()


def test_remote_stores_cycle_equals_the_sqlite_cycle(tmp_path, servers):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        local, local_summary = _cycle(tmp_path / "sqlite", {
            ("database", "data_store"): f"sqlite://{tmp_path}/sqlite/data.sqlite",
            ("database", "cache_store"): f"sqlite://{tmp_path}/sqlite/cache.sqlite",
            ("database", "vector_store"): f"sqlite://{tmp_path}/sqlite/vector.sqlite",
            ("database", "meta_store"): f"{tmp_path}/sqlite/meta.sqlite",
            ("blob", "uri"): f"{tmp_path}/sqlite/blob"})
        remote, summary = _cycle(tmp_path / "remote", {
            ("database", "data_store"): servers["mysql"].url(),
            ("database", "cache_store"): servers["redis"].url,
            ("database", "vector_store"): "hnsw://",
            ("database", "meta_store"): f"{tmp_path}/remote/meta.sqlite",
            ("blob", "uri"): servers["s3"].url(prefix="models") + f"&spool={tmp_path / 'w'}"})
    finally:
        torch.set_num_threads(threads)
    assert isinstance(remote.blob, ObjectBlobStore) and isinstance(remote.vectors,
                                                                  HNSWVectorStore)
    assert type(remote.data).__name__ == "GenericSQLDataStore"
    assert type(remote.cache).__name__ == "RedisCacheStore"
    assert summary["users_refreshed"] == local_summary["users_refreshed"] == N_USERS

    def content(cache, collection):
        return {k: sorted(v, key=lambda x: (-x[1], x[0]))
                for k, v in _caches(cache, collection).items()}

    for collection in (ck.NON_PERSONALIZED, ck.ITEM_TO_ITEM, ck.USER_TO_USER, ck.COLLABORATIVE,
                       ck.RECOMMEND):
        got, want = content(remote.cache, collection), content(local.cache, collection)
        assert got == want and got, collection
    for name in ("BEST_PARAMS_CF", "CF_SEARCH_TARGET", "BEST_PARAMS_CTR", "CF_MODEL_META"):
        assert remote.meta.get(name) == local.meta.get(name), name

    # the blobs the master saved, read back from S3 by a fresh store
    names = sorted(remote.blob.list())
    assert names == sorted([summary["cf_model_id"], summary["ctr_model_id"]])
    from gorse_tpu_torch.storage.object import open_blob_store

    fresh = open_blob_store(servers["s3"].url(prefix="models") + f"&spool={tmp_path / 'spool'}")
    try:
        for name in names:
            saved, read = remote.blob.path(name), fresh.open(name)
            files = sorted(p.relative_to(saved) for p in saved.rglob("*") if p.is_file())
            assert files and files == sorted(p.relative_to(read) for p in read.rglob("*")
                                             if p.is_file())
            assert all((saved / f).read_bytes() == (read / f).read_bytes() for f in files)
    finally:
        fresh.close()
    info = remote.vectors.describe_collection(Master.CF_COLLECTION)
    assert info == local.vectors.describe_collection(Master.CF_COLLECTION) and info["dimension"]
    for node in (remote, local):
        node.shutdown()
        for store in (node.data, node.cache, node.blob):
            store.close()
