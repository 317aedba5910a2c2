"""The port's config (gorse_tpu_torch/utils/config.py) against gorse_tpu's:
the repo's config.toml.example and the TOMLs of tests/test_config.py and
tests/test_config_reference.py load to equal trees (``dataclasses.asdict``
equal), with byte-equal ``to_json``, ``RecommendConfig.hash()`` and
``offline_recommend_digest()`` (the worker writes the hash into the cache,
the master hands the JSON to its nodes); each bad config those files try
raises the same ``ValueError``; durations, the ``GORSE_*`` overrides, the
blob section's override and fallback and the hot reload behave alike."""

import dataclasses
import time
from pathlib import Path

import pytest
from test_config import TOML as SMALL_TOML
from test_config_reference import REFERENCE_STYLE_TOML

import gorse_tpu.storage.object as ref_object
import gorse_tpu.utils.config as R
import gorse_tpu_torch.storage.object as port_object
import gorse_tpu_torch.utils.config as P

ROOT = Path(__file__).resolve().parents[1]
TOMLS = {
    "example": (ROOT / "config.toml.example").read_text(),
    "test_config": SMALL_TOML,
    "test_config_reference": REFERENCE_STYLE_TOML,
    "empty": "",
}


def _load_both(tmp_path, text):
    p = tmp_path / "config.toml"
    p.write_text(text)
    return P.load_config(p), R.load_config(p)


@pytest.mark.parametrize("name", sorted(TOMLS))
def test_loads_the_reference_tree(tmp_path, name):
    got, want = _load_both(tmp_path, TOMLS[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]


@pytest.mark.parametrize("name", sorted(TOMLS))
def test_json_and_digests_are_the_reference(tmp_path, name):
    got, want = _load_both(tmp_path, TOMLS[name])
    assert got.to_json() == want.to_json()
    assert got.recommend.hash() == want.recommend.hash()
    assert got.offline_recommend_digest() == want.offline_recommend_digest()
    assert got.recommend.list_recommenders() == want.recommend.list_recommenders()
    again = P.Config.from_json(want.to_json())
    assert again.to_json() == want.to_json()
    assert dataclasses.asdict(again) == dataclasses.asdict(R.Config.from_json(got.to_json()))


def test_defaults_are_the_reference():
    assert P.Config().to_json() == R.Config().to_json()
    assert P.default_config(env=False).to_json() == R.default_config(env=False).to_json()
    assert P.Config().recommend.hash() == R.Config().recommend.hash()


BAD = {
    "ranker_type": ("test_config", None, '[recommend.ranker]\ntype = "bogus"\n'),
    "i2i_type": ("test_config", None, '[[recommend.item_to_item]]\nname = "x"\ntype = "wrong"\n'),
    "feedback_expr": ("test_config", None,
                      '[recommend.data_source]\npositive_feedback_types = ["a b c >"]\n'),
    "isolation": ("test_config_reference",
                  ('isolation_level = "READ-UNCOMMITTED"', 'isolation_level = "CHAOS"'), None),
    "exporter": ("test_config_reference", ('exporter = "otlp"', 'exporter = "jaeger"'), None),
    "redirect": ("test_config_reference", ('redirect_url = ""', 'redirect_url = "https://x/cb"'),
                 None),
    "store_url": ("test_config_reference", ('data_store = "mysql://', 'data_store = "bogus://'),
                  None),
    "quantization": ("test_config_reference", ('quantization_type = "sq"',
                                               'quantization_type = "xq"'), None),
    "duration": ("test_config_reference", ('fit_period = "60m"', 'fit_period = "sixty"'), None),
    "u2u_type": ("test_config_reference", ('type = "items"', 'type = "nope"'), None),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_configs_raise_the_reference_error(tmp_path, case):
    base, swap, text = BAD[case]
    if text is None:
        text = TOMLS[base].replace(*swap)
        assert text != TOMLS[base]
    p = tmp_path / "bad.toml"
    p.write_text(text)
    with pytest.raises(ValueError) as want:
        R.load_config(p)
    with pytest.raises(ValueError) as got:
        P.load_config(p)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


@pytest.mark.parametrize("s", ["10s", "60m", "72h", "1m30s", "300ms", "0s", "0", "1.5h",
                               "2h45m10s", " 5s ", "1us", "7ns"])
def test_parse_go_duration_is_the_reference(s):
    assert P.parse_go_duration(s) == R.parse_go_duration(s)


@pytest.mark.parametrize("s", ["ten seconds", "5", "1d", "s", "1m30"])
def test_bad_durations_raise_like_the_reference(s):
    with pytest.raises(ValueError) as want:
        R.parse_go_duration(s)
    with pytest.raises(ValueError) as got:
        P.parse_go_duration(s)
    assert str(got.value) == str(want.value)


ENV = {
    "GORSE_DATA_STORE": "sqlite://env.db",
    "GORSE_MASTER_HTTP_PORT": "9999",
    "GORSE_DASHBOARD_REDACTED": "true",
    "GORSE_BLOB_URI": "/tmp/env-blob",
    "GORSE_VECTOR_QUANTIZATION_TYPE": "pq",
    "GORSE_VECTOR_QUANTIZATION_BITS": "4",
    "GORSE_SERVER_API_KEY": "123456",
    "GORSE_TABLE_PREFIX": "123",
    "GORSE_MASTER_SSL_MODE": "false",
    "GORSE_OIDC_ENABLE": "1",
}


@pytest.mark.parametrize("name", ["example", "test_config_reference"])
def test_env_overrides_are_the_reference(tmp_path, monkeypatch, name):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    got, want = _load_both(tmp_path, TOMLS[name])
    assert got.to_json() == want.to_json()
    assert got.database.data_store == "sqlite://env.db" and got.server.api_key == "123456"
    assert P.default_config().to_json() == R.default_config().to_json()
    raw = {"database": {"data_store": "memory://"}}
    assert P.apply_env_overrides(dict(raw), ENV) == R.apply_env_overrides(dict(raw), ENV)
    assert P.load_config(tmp_path / "config.toml", env=False).to_json() == \
        R.load_config(tmp_path / "config.toml", env=False).to_json()


@pytest.mark.parametrize("override,uri,fallback", [
    ("o", "u", "f"), ("", "u", "f"), ("", "", "f"), ("o", "", ""), ("file://o", "u", "f"),
    ("", "file://u", "f"),
])
def test_blob_section_override_and_fallback(tmp_path, override, uri, fallback):
    """database.blob_store wins over [blob].uri, the fallback applies when
    neither is set, a file:// URL is a path: the same directory as the
    reference's opener."""
    def where(name):
        if not name:
            return ""
        return f"file://{tmp_path / name[7:]}" if name.startswith("file://") else str(tmp_path / name)

    args = (where(override), where(fallback))
    got = port_object.open_blob_store_from_config(P.BlobConfig(uri=where(uri)), *args)
    want = ref_object.open_blob_store_from_config(R.BlobConfig(uri=where(uri)), *args)
    assert got.root == want.root and got.root.is_dir()
    cfg = P.Config()
    cfg.database.blob_store, cfg.blob.uri = where(override), where(uri)
    ref_cfg = R.Config()
    ref_cfg.database.blob_store, ref_cfg.blob.uri = where(override), where(uri)
    assert cfg.blob_store_url(args[1]) == ref_cfg.blob_store_url(args[1])


@pytest.mark.parametrize("url", ["s3://bucket/prefix", "gs://bucket/prefix",
                                 "azblob://container/prefix"])
def test_remote_blob_stores_raise_m21(url):
    """The remote blob stores open (no longer raising M21): the port's
    ``ObjectBlobStore`` over the client the reference builds for the URL,
    field for field (a client reaches the network only when called)."""
    for got, want in ((port_object.open_blob_store(url), ref_object.open_blob_store(url)),
                      (port_object.open_blob_store_from_config(P.BlobConfig(uri=url)),
                       ref_object.open_blob_store_from_config(R.BlobConfig(uri=url)))):
        try:
            assert type(got).__name__ == type(want).__name__ == "ObjectBlobStore"
            assert type(got.client).__name__ == type(want.client).__name__
            assert vars(got.client) == vars(want.client)
        finally:
            got.close()
            want.close()


def test_config_watcher_reloads_the_reference_config(tmp_path):
    p = tmp_path / "config.toml"
    p.write_text("[recommend]\ncache_size = 1\n")
    seen = []
    watcher = P.ConfigWatcher(p, seen.append, interval=0.05)
    watcher.start()
    time.sleep(0.1)
    p.write_text(REFERENCE_STYLE_TOML.replace("cache_size = 100", "cache_size = 2"))
    deadline = time.time() + 10
    while not seen and time.time() < deadline:
        time.sleep(0.05)
    watcher.stop()
    assert seen and seen[-1].recommend.cache_size == 2
    assert seen[-1].to_json() == R.load_config(p).to_json()


def test_config_watcher_keeps_going_after_a_bad_file(tmp_path):
    p = tmp_path / "config.toml"
    p.write_text("[recommend]\ncache_size = 1\n")
    seen = []
    watcher = P.ConfigWatcher(p, seen.append, interval=0.05)
    watcher.start()
    time.sleep(0.1)
    p.write_text('[recommend.ranker]\ntype = "bogus"\n')
    time.sleep(0.6)
    assert not seen
    p.write_text("[recommend]\ncache_size = 3\n")
    deadline = time.time() + 10
    while not seen and time.time() < deadline:
        time.sleep(0.05)
    watcher.stop()
    assert seen and seen[-1].recommend.cache_size == 3
