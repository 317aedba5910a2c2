"""The port's remote blob stores (gorse_tpu_torch/storage/object.py: S3,
GCS, Azure Blob over stdlib REST) and its signature-verifying servers
(storage/miniobj.py) against gorse_tpu's.

The signers give the reference's header for fixed inputs (date, region,
keys, paths that need ``_uri_encode``). A blob written through either
package's store, on either package's server, reads back byte for byte
through the other's; listings paginate and removal leaves the same
objects. ``open_blob_store_from_config`` builds the reference's client from
the ``[blob.s3]`` and ``[blob.azure]`` sections and the Azure connection
string (clients reach the network only when called). Bad keys are
refused."""

import numpy as np
import pytest

import gorse_tpu.storage.miniobj as RMO
import gorse_tpu.storage.object as RO
import gorse_tpu.utils.config as RCFG
import gorse_tpu_torch.storage.miniobj as PMO
import gorse_tpu_torch.storage.object as PO
import gorse_tpu_torch.utils.config as PCFG

PACKAGES = {"port": (PO, PMO), "ref": (RO, RMO)}
BACKENDS = {"s3": "MiniS3", "gcs": "MiniGCS", "azure": "MiniAzure"}


# ----------------------------------------------------------------- signatures


SIGV4 = [
    ("GET", "/gorse/models/1700000000000/meta.json", {}, {"host": "127.0.0.1:9000"}, b"",
     "minio", "miniosecret", "us-east-1", "20240101T000000Z"),
    ("PUT", "/bucket/a b/ü/x+y=z.bin", {"partNumber": "1", "uploadId": "a/b c"},
     {"host": "s3.amazonaws.com", "content-type": "application/octet-stream",
      "x-amz-meta-Name": "  spaced  value "}, bytes(range(256)), "AKIDEXAMPLE",
     "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", "eu-west-3", "20261018T043000Z"),
    ("GET", "/bucket", {"list-type": "2", "prefix": "models/", "continuation-token": "tok==/+"},
     {"host": "localhost"}, b"", "k", "s", "ap-south-1", "20000229T235959Z"),
    ("DELETE", "/b/~tilde-._/%", {}, {"host": "h:1"}, b"x" * 10_000, "ak", "sk", "us-west-2",
     "20991231T120000Z"),
]


@pytest.mark.parametrize("args", SIGV4, ids=[a[0] + "-" + a[7] for a in SIGV4])
def test_sigv4_is_the_reference(args):
    assert PO.sigv4_sign(*args) == RO.sigv4_sign(*args)
    assert PO.sigv4_sign(*args, service="s3") == RO.sigv4_sign(*args, service="s3")


AZURE = [
    ("devstoreaccount1", "a2V5a2V5a2V5", "PUT", "/gorse/models/1/meta.json", {},
     {"x-ms-blob-type": "BlockBlob", "Content-Type": "application/octet-stream",
      "x-ms-date": "Sun, 18 Oct 2026 04:30:00 GMT", "x-ms-version": "2021-08-06"}, 17),
    ("acct", "c2VjcmV0LWtleS0xMjM0NTY3ODkw", "GET", "/c", {"restype": "container",
     "comp": "list", "prefix": "m/", "marker": "2!abc"},
     {"x-ms-date": "Mon, 01 Jan 2024 00:00:00 GMT", "x-ms-version": "2021-08-06"}, 0),
    ("acct", "c2VjcmV0", "DELETE", "/c/a b/ü.bin", {},
     {"x-ms-date": "Tue, 29 Feb 2000 23:59:59 GMT", "x-ms-version": "2021-08-06",
      "x-ms-client-request-id": "id"}, 0),
]


@pytest.mark.parametrize("args", AZURE, ids=[a[2] for a in AZURE])
def test_azure_shared_key_is_the_reference(args):
    assert PO.azure_shared_key_sign(*args) == RO.azure_shared_key_sign(*args)


def test_uri_encode_is_the_reference():
    for s in ("", "a b", "ü/x+y=z", "~-._", "%2F", "/a//b/", "?&#"):
        for slash in (True, False):
            assert PO._uri_encode(s, slash) == RO._uri_encode(s, slash)


# ------------------------------------------------------------------ round trips


@pytest.fixture(scope="module")
def servers():
    """Each backend's server from each package, shared by the module."""
    started = {(b, pkg): getattr(PACKAGES[pkg][1], cls)().start()
               for b, cls in BACKENDS.items() for pkg in PACKAGES}
    yield started
    for mini in started.values():
        mini.stop()


def _files(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"factors.npz": rng.bytes(70_000), "meta.json": b'{"n_factors": 16}',
            "sub/dir/extra.bin": bytes(range(256)), "ünï code.txt": "ü".encode()}


def _write(store, name: str, files: dict) -> None:
    d = store.create(name)
    for rel, data in files.items():
        p = d / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
    store.flush(name)


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_blobs_cross_packages(tmp_path, servers, backend, writer, reader, server_pkg):
    mini = servers[backend, server_pkg]
    prefix = f"{writer}-{reader}"
    url = mini.url(prefix=prefix)
    wrote = PACKAGES[writer][0].open_blob_store(f"{url}&spool={tmp_path / 'w'}")
    read = PACKAGES[reader][0].open_blob_store(f"{url}&spool={tmp_path / 'r'}")
    try:
        names = [f"17000000000{n:02d}" for n in range(3)]
        for n, name in enumerate(names):
            _write(wrote, name, _files(n))
        assert read.list() == wrote.list() == names and read.ping()
        for n, name in enumerate(names):
            d = read.open(name)
            for rel, data in _files(n).items():
                assert (d / rel).read_bytes() == data
        read.remove(names[0])
        assert wrote.list() == names[1:] and not wrote.exists(names[0])
        with pytest.raises(FileNotFoundError):
            wrote.open(names[0])
    finally:
        wrote.close()
        read.close()


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
@pytest.mark.parametrize("backend", ["s3", "azure"])
def test_bad_keys_are_refused(tmp_path, servers, backend, server_pkg):
    mini = servers[backend, server_pkg]
    good = mini.url(prefix="refused")
    bad = (good.replace("miniosecret", "wrongsecret") if backend == "s3"
           else good.replace("a2V5a2V5a2V5", "d3Jvbmd3cm9uZw%3D%3D"))
    assert bad != good
    for pkg in PACKAGES:
        store = PACKAGES[pkg][0].open_blob_store(f"{bad}&spool={tmp_path / pkg}")
        with pytest.raises(IOError):
            _write(store, "m1", {"a": b"x"})
        store.close()


# ------------------------------------------------------------------- openers


CONFIGS = [
    ("s3://models/gorse", {"s3": {"endpoint": "http://minio:9000", "access_key_id": "ak",
                                  "secret_access_key": "s/k+"}}),
    ("s3://bucket", {"s3": {"access_key_id": "ak", "secret_access_key": "sk"}}),
    ("s3://bucket/p?region=eu-west-1", {"s3": {"endpoint": "https://s3.example:8443",
                                               "access_key_id": "a", "secret_access_key": "b"}}),
    ("s3://AK:SK@host:9000/bucket/p", {}),
    ("gs://bucket/prefix", {}),
    ("gcs://bucket/p?endpoint=http://fake:4443&token=t", {}),
    ("azblob://container/prefix", {"azure": {"account_name": "acct", "account_key": "a2V5"}}),
    ("azblob://container", {"azure": {"connection_string": (
        "DefaultEndpointsProtocol=http;AccountName=devstoreaccount1;AccountKey=a2V5a2V5a2V5;"
        "BlobEndpoint=http://azurite:10000/devstoreaccount1")}}),
    ("azblob://c/p", {"azure": {"connection_string": (
        "DefaultEndpointsProtocol=https;AccountName=acct;AccountKey=a2V5;"
        "EndpointSuffix=core.chinacloudapi.cn")}}),
    ("azblob://c/p", {"azure": {"account_name": "acct", "account_key": "k",
                                "endpoint": "https://custom.blob:443"}}),
]


def _blob_cfg(mod, uri: str, sections: dict):
    cfg = mod.BlobConfig(uri=uri)
    for section, values in sections.items():
        for key, value in values.items():
            setattr(getattr(cfg, section), key, value)
    return cfg


@pytest.mark.parametrize("uri,sections", CONFIGS, ids=[f"{n}-{c[0].split(':')[0]}"
                                                       for n, c in enumerate(CONFIGS)])
def test_from_config_builds_the_reference_client(uri, sections):
    got = PO.open_blob_store_from_config(_blob_cfg(PCFG, uri, sections))
    want = RO.open_blob_store_from_config(_blob_cfg(RCFG, uri, sections))
    try:
        assert type(got).__name__ == type(want).__name__ == "ObjectBlobStore"
        assert type(got.client).__name__ == type(want.client).__name__
        assert type(got.client).__module__ == PO.__name__
        assert vars(got.client) == vars(want.client)
    finally:
        got.close()
        want.close()


def test_plain_paths_and_unknown_schemes(tmp_path):
    from gorse_tpu_torch.storage.blob import BlobStore

    for url in (str(tmp_path / "a"), f"file://{tmp_path / 'b'}"):
        store = PO.open_blob_store(url)
        assert type(store) is BlobStore
    with pytest.raises(ValueError):
        PO.open_blob_store("ftp://nope")
    assert PO.open_blob_store_from_config(PCFG.BlobConfig(), fallback=str(tmp_path / "c")).root \
        == tmp_path / "c"
