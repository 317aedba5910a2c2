"""Configuration tree with TOML load, validation and hot reload (port of
gorse_tpu/utils/config.py, which needs no JAX; the port keeps its own copy
with the same names, defaults, field order and digests).

One ``Config`` with the Database, Master, Server, Recommend (DataSource,
Search, NonPersonalized, ItemToItem, UserToUser, Collaborative, Ranker,
Fallback, Replacement, External), Tracing, OIDC, OpenAI and Blob sections
of gorse's ``config.toml``, loaded with the stdlib ``tomllib``. Dash section
names (``[[recommend.item-to-item]]``) become underscores, and Go duration
strings (``"10s"``, ``"60m"``, ``"72h"``) are parsed into each field's
native unit (seconds, minutes or hours, noted per field). ``GORSE_*``
environment variables override the file. Hot reload is an mtime watcher
with a debounce. ``Config.to_json`` (the master's meta payload),
``RecommendConfig.hash()`` (the digest the worker writes into the cache)
and ``offline_recommend_digest`` give gorse_tpu's strings byte for byte.
Line references such as ``config/config.go:79`` are to upstream gorse.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import re
import threading
import time
import tomllib
from pathlib import Path
from typing import Callable

from .expression import FeedbackTypeExpression, parse_expressions

logger = logging.getLogger(__name__)

# --------------------------------------------------------------- durations

_DURATION_RE = re.compile(r"([+-]?\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNIT_S = {
    "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0,
}


def parse_go_duration(s: str) -> float:
    """Parse a Go ``time.Duration`` string into seconds (gorse configs
    write durations as e.g. ``"10s"``, ``"60m"``, ``"1m30s"``, ``"0s"``)."""
    s = s.strip()
    if s in ("0", "", "0s"):
        return 0.0
    parts = _DURATION_RE.findall(s)
    if not parts or "".join(f"{n}{u}" for n, u in parts) != s.lstrip("+"):
        raise ValueError(f"invalid duration {s!r}")
    return sum(float(n) * _DURATION_UNIT_S[u] for n, u in parts)


def _coerce_duration(v, unit_seconds: float) -> float:
    """TOML duration strings are Go durations; bare numbers are taken to
    already be in the field's native unit (back-compat with older configs)."""
    if isinstance(v, str):
        return parse_go_duration(v) / unit_seconds
    return float(v)


# ------------------------------------------------------------- dataclasses


@dataclasses.dataclass
class MySQLConfig:
    """Reference: config.MySQLConfig (config/config.go:90-96)."""

    isolation_level: str = "READ-UNCOMMITTED"
    max_open_conns: int = 0
    max_idle_conns: int = 0
    conn_max_lifetime: float = 0.0  # seconds


@dataclasses.dataclass
class SQLPoolConfig:
    """Reference: config.SQLConfig (config/config.go:98-102) — Postgres pool."""

    max_open_conns: int = 64
    max_idle_conns: int = 64
    conn_max_lifetime: float = 60.0  # seconds


@dataclasses.dataclass
class RedisConfig:
    """Reference: config.RedisConfig (config/config.go:104-106)."""

    max_search_results: int = 10000


@dataclasses.dataclass
class DatabaseConfig:
    data_store: str = "memory://"
    cache_store: str = "memory://"
    blob_store: str = ""  # directory path; empty -> [blob].uri or <workdir>/blobs
    meta_store: str = ":memory:"
    vector_store: str = ""  # empty -> CF served straight from the device index
    # table prefixes (gorse: config/config.go:79-83)
    table_prefix: str = ""
    data_table_prefix: str = ""
    cache_table_prefix: str = ""
    vector_table_prefix: str = ""
    cache_client_name: str = "gorse_cache_client"
    mysql: MySQLConfig = dataclasses.field(default_factory=MySQLConfig)
    postgres: SQLPoolConfig = dataclasses.field(default_factory=SQLPoolConfig)
    redis: RedisConfig = dataclasses.field(default_factory=RedisConfig)
    # vector quantization (gorse: config/config.go:106-108 VectorConfig,
    # TOML section [database.vector])
    vector_quantization_type: str = ""  # "" | "sq" | "pq" | "rq"
    vector_quantization_bits: int = 0

    def effective_data_prefix(self) -> str:
        return self.data_table_prefix or self.table_prefix

    def effective_cache_prefix(self) -> str:
        return self.cache_table_prefix or self.table_prefix


@dataclasses.dataclass
class MasterConfig:
    # bind-all defaults match gorse's (GetDefaultConfig,
    # config/config.go:491-499) so dockerized deployments behave identically
    host: str = "0.0.0.0"
    port: int = 8086
    http_host: str = "0.0.0.0"
    http_port: int = 8088
    http_cors_domains: list[str] = dataclasses.field(default_factory=lambda: [".*"])
    http_cors_methods: list[str] = dataclasses.field(
        default_factory=lambda: ["GET", "POST", "PUT", "DELETE", "PATCH"]
    )
    n_jobs: int = 1
    meta_timeout: float = 10.0  # seconds
    dashboard_user_name: str = ""
    dashboard_password: str = ""
    dashboard_redacted: bool = False
    admin_api_key: str = ""
    # mutual TLS for the gRPC control plane (gorse: config/config.go:141-145)
    ssl_mode: bool = False
    ssl_ca: str = ""
    ssl_cert: str = ""
    ssl_key: str = ""


@dataclasses.dataclass
class ServerConfig:
    api_key: str = ""
    http_host: str = "127.0.0.1"
    http_port: int = 8087
    clock_error: float = 5.0  # seconds
    epsilon: float = 0.0
    default_n: int = 10  # gorse: config.go:160,502
    auto_insert_user: bool = True  # insert new users while inserting feedback
    auto_insert_item: bool = True  # insert new items while inserting feedback
    cache_expire: float = 10.0  # seconds; server-side response cache


@dataclasses.dataclass
class DataSourceConfig:
    positive_feedback_types: list[str] = dataclasses.field(default_factory=lambda: ["like"])
    read_feedback_types: list[str] = dataclasses.field(default_factory=lambda: ["read"])
    negative_feedback_types: list[str] = dataclasses.field(default_factory=list)
    positive_feedback_ttl: int = 0  # days; 0 = unlimited
    item_ttl: int = 0  # days

    def positive_exprs(self) -> list[FeedbackTypeExpression]:
        return parse_expressions(self.positive_feedback_types)


@dataclasses.dataclass
class NonPersonalizedConfigEntry:
    name: str
    score: str = "len(feedback)"
    filter: str = ""


@dataclasses.dataclass
class ItemToItemConfigEntry:
    name: str
    type: str = "auto"
    column: str = ""
    prompt: str = ""  # chat type: jinja template rendered per item


@dataclasses.dataclass
class UserToUserConfigEntry:
    name: str
    type: str = "auto"
    column: str = ""


@dataclasses.dataclass
class EarlyStoppingConfig:
    """Reference: config.EarlyStoppingConfig (config/config.go:361-363)."""

    patience: int = 0


@dataclasses.dataclass
class CollaborativeConfig:
    """Reference: config.CollaborativeConfig (config/config.go:338-345)."""

    type: str = "none"  # none | mf — CF is opt-in, like the gorse's
    # hard default (GetDefaultConfig config/config.go:512); the shipped
    # config.toml example enables "mf"
    fit_period: float = 60.0  # minutes
    fit_epoch: int = 100  # default n_epochs for master fits (config.go:514); 0 = model default
    optimize_period: float = 0.0  # minutes; 0 disables periodic search
    optimize_trials: int = 10
    early_stopping: EarlyStoppingConfig = dataclasses.field(default_factory=EarlyStoppingConfig)
    enable_index: bool = True
    # serving-index recall: < 1.0 selects gorse_tpu's approximate tier; the
    # port serves exact top-k, which meets any recall target
    index_recall: float = 1.0
    model: str = "bpr"  # bpr | als
    model_search_epoch: int = 10  # epochs per hyper-search trial

    # back-compat aliases (pre-gorse-schema field names)
    @property
    def model_fit_period(self) -> float:
        return self.fit_period

    @property
    def model_search_trials(self) -> int:
        return self.optimize_trials


@dataclasses.dataclass
class RerankerAPIConfig:
    """Reference: config.RerankerAPIConfig (config/config.go:520-524)."""

    auth_token: str = ""
    model: str = ""
    url: str = ""


@dataclasses.dataclass
class RankerConfig:
    """Reference: config.RankerConfig (config/config.go:381-393)."""

    type: str = "none"  # none | fm | llm — ranking is opt-in (config.go:525)
    recommenders: list[str] = dataclasses.field(default_factory=lambda: ["latest"])
    cache_expire: float = 120.0  # hours
    fit_period: float = 60.0  # minutes
    fit_epoch: int = 100  # default n_epochs for master fits (config.go:529); 0 = model default
    optimize_period: float = 0.0  # minutes
    optimize_trials: int = 10
    query_template: str = ""
    document_template: str = ""
    early_stopping: EarlyStoppingConfig = dataclasses.field(default_factory=EarlyStoppingConfig)
    reranker_api: RerankerAPIConfig = dataclasses.field(default_factory=RerankerAPIConfig)
    lift_threshold: float = 0.0
    prompt: str = ""  # llm type: chat-completion rerank prompt

    @property
    def model_fit_period(self) -> float:
        return self.fit_period


@dataclasses.dataclass
class FallbackConfig:
    recommenders: list[str] = dataclasses.field(default_factory=lambda: ["latest"])
    num_feedback_fallback_item_based: int = 10


@dataclasses.dataclass
class ReplacementConfig:
    enable_replacement: bool = False
    positive_replacement_decay: float = 0.8
    read_replacement_decay: float = 0.6


@dataclasses.dataclass
class ExternalConfigEntry:
    """Reference: config.ExternalConfig{Name, Script} (config/config.go:367-370).
    ``script`` is the gorse's JavaScript hook, run by the embedded mini-JS
    interpreter; ``http``/``python`` are transport shortcuts."""

    name: str
    type: str = ""  # js | python | http; defaults to js when script is set
    url: str = ""
    script: str = ""
    timeout: float = 5.0

    def __post_init__(self) -> None:
        if not self.type:
            self.type = "js" if self.script else "python"

    def digest(self) -> str:
        return hashlib.md5(
            f"{self.name}|{self.type}|{self.url}|{self.script}".encode()
        ).hexdigest()


@dataclasses.dataclass
class SearchConfig:
    """Full-text item-search columns (gorse: config.SearchConfig,
    config/config.go:264 — item expressions like item_id/comment/labels.title
    maintained by the data store's Reconcile)."""

    columns: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RecommendConfig:
    cache_size: int = 100
    cache_expire: float = 72.0  # hours
    context_size: int = 100  # gorse's default (config/config.go setDefault)
    active_user_ttl: int = 0  # days; skip recomputation for inactive users
    data_source: DataSourceConfig = dataclasses.field(default_factory=DataSourceConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    non_personalized: list[NonPersonalizedConfigEntry] = dataclasses.field(default_factory=list)
    item_to_item: list[ItemToItemConfigEntry] = dataclasses.field(default_factory=list)
    user_to_user: list[UserToUserConfigEntry] = dataclasses.field(default_factory=list)
    collaborative: CollaborativeConfig = dataclasses.field(default_factory=CollaborativeConfig)
    ranker: RankerConfig = dataclasses.field(default_factory=RankerConfig)
    fallback: FallbackConfig = dataclasses.field(default_factory=FallbackConfig)
    replacement: ReplacementConfig = dataclasses.field(default_factory=ReplacementConfig)
    external: list[ExternalConfigEntry] = dataclasses.field(default_factory=list)

    def list_recommenders(self) -> list[str]:
        """All configured recommendation sources by full name (gorse:
        RecommendConfig.ListRecommenders config/config.go:186-203)."""
        out = [f"non-personalized/{e.name}" for e in self.non_personalized]
        out += [f"item-to-item/{e.name}" for e in self.item_to_item]
        out += [f"user-to-user/{e.name}" for e in self.user_to_user]
        out += [f"external/{e.name}" for e in self.external]
        out.append("collaborative")
        out.append("latest")
        return out

    def hash(self) -> str:
        """Digest of exactly the recommenders feeding offline recommendation
        (gorse: RecommendConfig.Hash config/config.go:205-237): only
        entries named in ranker.recommenders (or all when that list is
        empty) contribute, and feedback-type-dependent similarities fold the
        positive/negative feedback expressions into their digest."""
        selected = set(self.ranker.recommenders) or set(self.list_recommenders())
        fb_types = "|".join(
            self.data_source.positive_feedback_types
            + self.data_source.negative_feedback_types
        )
        digests: list[str] = []
        for np_e in self.non_personalized:
            if f"non-personalized/{np_e.name}" in selected:
                digests.append(
                    hashlib.md5(
                        f"{np_e.name}{np_e.score}{np_e.filter}".encode()
                    ).hexdigest()
                )
        for i2i in self.item_to_item:
            if f"item-to-item/{i2i.name}" in selected:
                extra = fb_types if i2i.type == "users" else ""
                digests.append(
                    hashlib.md5(
                        f"{i2i.name}{i2i.type}{i2i.column}{i2i.prompt}{extra}".encode()
                    ).hexdigest()
                )
        for u2u in self.user_to_user:
            if f"user-to-user/{u2u.name}" in selected:
                extra = fb_types if u2u.type == "items" else ""
                digests.append(
                    hashlib.md5(
                        f"{u2u.name}{u2u.type}{u2u.column}{extra}".encode()
                    ).hexdigest()
                )
        for ext in self.external:
            if f"external/{ext.name}" in selected:
                digests.append(ext.digest())
        if "collaborative" in selected:
            digests.append(hashlib.md5(fb_types.encode()).hexdigest())
        if "latest" in selected:
            digests.append("latest")
        return hashlib.md5("".join(digests).encode()).hexdigest()


@dataclasses.dataclass
class OpenAIConfig:
    base_url: str = ""
    auth_token: str = ""
    chat_completion_model: str = ""
    embedding_model: str = ""
    embedding_dimensions: int = 0
    chat_completion_rpm: int = 60
    chat_completion_tpm: int = 100000
    embedding_rpm: int = 600
    embedding_tpm: int = 1000000
    log_file: str = ""


@dataclasses.dataclass
class TracingConfig:
    """Reference: config.TracingConfig (config/config.go:399-405); the TOML
    key is ``enable_tracing`` (accepted as an alias of ``enable``)."""

    enable: bool = False
    exporter: str = "otlp"
    sampler: str = "always"
    ratio: float = 1.0
    collector_endpoint: str = ""


@dataclasses.dataclass
class OIDCConfig:
    """Dashboard single sign-on (gorse: config/config.go:415-421)."""

    enable: bool = False
    issuer: str = ""
    client_id: str = ""
    client_secret: str = ""
    redirect_url: str = ""


@dataclasses.dataclass
class S3Config:
    """Reference: config.S3Config (config/config.go:449-453)."""

    endpoint: str = ""
    access_key_id: str = ""
    secret_access_key: str = ""


@dataclasses.dataclass
class GCSConfig:
    """Reference: config.GCSConfig (config/config.go:455-457)."""

    credentials_file: str = ""


@dataclasses.dataclass
class AzureBlobConfig:
    """Reference: config.AzureBlobConfig (config/config.go:459-464)."""

    endpoint: str = ""
    account_name: str = ""
    account_key: str = ""
    connection_string: str = ""


@dataclasses.dataclass
class BlobConfig:
    """Model-artifact store (gorse: config.BlobConfig config/config.go:442-447;
    TOML section [blob])."""

    uri: str = ""
    s3: S3Config = dataclasses.field(default_factory=S3Config)
    gcs: GCSConfig = dataclasses.field(default_factory=GCSConfig)
    azure: AzureBlobConfig = dataclasses.field(default_factory=AzureBlobConfig)


@dataclasses.dataclass
class Config:
    database: DatabaseConfig = dataclasses.field(default_factory=DatabaseConfig)
    master: MasterConfig = dataclasses.field(default_factory=MasterConfig)
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    recommend: RecommendConfig = dataclasses.field(default_factory=RecommendConfig)
    openai: OpenAIConfig = dataclasses.field(default_factory=OpenAIConfig)
    tracing: TracingConfig = dataclasses.field(default_factory=TracingConfig)
    oidc: OIDCConfig = dataclasses.field(default_factory=OIDCConfig)
    blob: BlobConfig = dataclasses.field(default_factory=BlobConfig)

    # ------------------------------------------------------------ validation

    def validate(self) -> None:
        """Strict validation (gorse: go-playground validators + custom
        data_store/item_expr checks)."""
        for url, kinds in (
            (self.database.data_store,
             ("memory://", "sqlite://", "proxy://", "none://", "mysql://",
              "postgres://", "postgresql://", "clickhouse://", "mongodb://")),
            (self.database.cache_store,
             ("memory://", "sqlite://", "proxy://", "redis://", "none://",
              "mysql://", "postgres://", "postgresql://", "mongodb://")),
            (self.database.vector_store,
             ("memory://", "sqlite://", "proxy://", "none://", "hnsw://",
              "qdrant://", "weaviate://", "milvus://")),
        ):
            if url and not any(url.startswith(k) or url == k.rstrip("://") for k in kinds):
                raise ValueError(f"unsupported store URL {url!r}")
        if self.database.vector_quantization_type not in ("", "sq", "pq", "rq"):
            raise ValueError(
                f"unsupported vector quantization {self.database.vector_quantization_type!r}"
            )
        if self.database.mysql.isolation_level not in (
            "READ-UNCOMMITTED", "READ-COMMITTED", "REPEATABLE-READ", "SERIALIZABLE",
        ):
            raise ValueError(
                f"invalid mysql isolation level {self.database.mysql.isolation_level!r}"
            )
        for spec in (
            self.recommend.data_source.positive_feedback_types
            + self.recommend.data_source.read_feedback_types
            + self.recommend.data_source.negative_feedback_types
        ):
            FeedbackTypeExpression.parse(spec)  # raises on invalid
        if self.recommend.ranker.type not in ("none", "fm", "llm"):
            raise ValueError(f"invalid ranker type {self.recommend.ranker.type!r}")
        if self.recommend.collaborative.model not in ("bpr", "als"):
            raise ValueError(f"invalid collaborative model {self.recommend.collaborative.model!r}")
        if self.recommend.collaborative.type not in ("none", "mf"):
            raise ValueError(f"invalid collaborative type {self.recommend.collaborative.type!r}")
        if self.tracing.exporter not in ("zipkin", "otlp", "otlphttp"):
            raise ValueError(f"invalid tracing exporter {self.tracing.exporter!r}")
        if self.oidc.redirect_url and not self.oidc.redirect_url.endswith("/callback/oauth2"):
            raise ValueError("oidc redirect_url must end with /callback/oauth2")
        from .safe_expr import SafeExpression

        for np_cfg in self.recommend.non_personalized:
            SafeExpression(np_cfg.score)
            if np_cfg.filter:
                SafeExpression(np_cfg.filter)
        for i2i in self.recommend.item_to_item:
            if i2i.type not in ("embedding", "tags", "users", "auto", "chat"):
                raise ValueError(f"invalid item-to-item type {i2i.type!r}")
        for u2u in self.recommend.user_to_user:
            if u2u.type not in ("embedding", "tags", "items", "auto"):
                raise ValueError(f"invalid user-to-user type {u2u.type!r}")

    # -------------------------------------------------------------- digests

    def offline_recommend_digest(self) -> str:
        """Digest of everything that invalidates offline recommendations
        (gorse: config OfflineRecommendDigest :204-236)."""
        payload = json.dumps(
            dataclasses.asdict(self.recommend), sort_keys=True, default=str
        )
        return hashlib.md5(payload.encode()).hexdigest()

    def blob_store_url(self, default: str = "") -> str:
        """Resolve the blob store location: database.blob_store overrides the
        [blob] section (gorse keeps them in BlobConfig only)."""
        return self.database.blob_store or self.blob.uri or default

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return _from_dict(cls, json.loads(s))


# --------------------------------------------------------------- dict → cfg

_LIST_FIELDS = {
    "non_personalized": NonPersonalizedConfigEntry,
    "item_to_item": ItemToItemConfigEntry,
    "user_to_user": UserToUserConfigEntry,
    "external": ExternalConfigEntry,
}

# duration-typed fields: (dataclass, field) -> native unit in seconds.
# TOML string values are parsed as Go durations and converted to this unit;
# bare numbers are taken as already being in this unit.
_DURATION_FIELDS: dict[tuple[type, str], float] = {
    (MasterConfig, "meta_timeout"): 1.0,
    (ServerConfig, "clock_error"): 1.0,
    (ServerConfig, "cache_expire"): 1.0,
    (RecommendConfig, "cache_expire"): 3600.0,
    (CollaborativeConfig, "fit_period"): 60.0,
    (CollaborativeConfig, "optimize_period"): 60.0,
    (RankerConfig, "cache_expire"): 3600.0,
    (RankerConfig, "fit_period"): 60.0,
    (RankerConfig, "optimize_period"): 60.0,
    (MySQLConfig, "conn_max_lifetime"): 1.0,
    (SQLPoolConfig, "conn_max_lifetime"): 1.0,
}

# key aliases folded before field mapping, per dataclass
_KEY_ALIASES: dict[type, dict[str, str]] = {
    TracingConfig: {"enable_tracing": "enable"},
    CollaborativeConfig: {
        "model_fit_period": "fit_period",
        "model_search_trials": "optimize_trials",
    },
    RankerConfig: {"model_fit_period": "fit_period"},
}


def _normalize_keys(obj):
    """Recursively turn dash keys into underscores so gorse TOML section
    names ([[recommend.item-to-item]], non-personalized, ...) map onto the
    dataclass fields."""
    if isinstance(obj, dict):
        return {k.replace("-", "_"): _normalize_keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_normalize_keys(v) for v in obj]
    return obj


def _from_dict(cls, d: dict):
    """Recursively map a plain dict onto nested dataclasses, tolerating
    unknown keys (forward compatibility, like mapstructure)."""
    if not dataclasses.is_dataclass(cls):
        return d
    import typing

    d = _normalize_keys(d)
    for alias, canonical in _KEY_ALIASES.get(cls, {}).items():
        if alias in d and canonical not in d:
            d[canonical] = d.pop(alias)
    if cls is DatabaseConfig and isinstance(d.get("vector"), dict):
        # [database.vector] quantization_type/bits (gorse's VectorConfig)
        vec = d.pop("vector")
        d.setdefault("vector_quantization_type", vec.get("quantization_type", ""))
        d.setdefault("vector_quantization_bits", vec.get("quantization_bits", 0))

    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for name, f in fields.items():
        if name not in d:
            continue
        v = d[name]
        ftype = hints.get(name, f.type)
        if (cls, name) in _DURATION_FIELDS:
            kwargs[name] = _coerce_duration(v, _DURATION_FIELDS[(cls, name)])
        elif isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[name] = _from_dict(ftype, v)
        elif name in _LIST_FIELDS and isinstance(v, list):
            kwargs[name] = [_from_dict(_LIST_FIELDS[name], e) for e in v]
        else:
            kwargs[name] = v
    return cls(**kwargs)


# GORSE_* environment overrides (gorse: config/config.go:690-721
# viper.BindEnv table — same variable names, applied over the file config).
# The third element is the target type: env strings are coerced by the
# DESTINATION field's type, never by what the value happens to look like
# (an api key of "123456" must stay a string).
_ENV_BINDINGS: list[tuple[str, str, type]] = [
    ("database.cache_store", "GORSE_CACHE_STORE", str),
    ("database.data_store", "GORSE_DATA_STORE", str),
    ("database.vector_store", "GORSE_VECTOR_STORE", str),
    ("database.table_prefix", "GORSE_TABLE_PREFIX", str),
    ("database.cache_table_prefix", "GORSE_CACHE_TABLE_PREFIX", str),
    ("database.cache_client_name", "GORSE_CACHE_CLIENT_NAME", str),
    ("database.data_table_prefix", "GORSE_DATA_TABLE_PREFIX", str),
    ("database.vector_table_prefix", "GORSE_VECTOR_TABLE_PREFIX", str),
    ("database.vector.quantization_type", "GORSE_VECTOR_QUANTIZATION_TYPE", str),
    ("database.vector.quantization_bits", "GORSE_VECTOR_QUANTIZATION_BITS", int),
    ("master.port", "GORSE_MASTER_PORT", int),
    ("master.host", "GORSE_MASTER_HOST", str),
    ("master.ssl_mode", "GORSE_MASTER_SSL_MODE", bool),
    ("master.ssl_ca", "GORSE_MASTER_SSL_CA", str),
    ("master.ssl_cert", "GORSE_MASTER_SSL_CERT", str),
    ("master.ssl_key", "GORSE_MASTER_SSL_KEY", str),
    ("master.http_port", "GORSE_MASTER_HTTP_PORT", int),
    ("master.http_host", "GORSE_MASTER_HTTP_HOST", str),
    ("master.n_jobs", "GORSE_MASTER_JOBS", int),
    ("master.dashboard_user_name", "GORSE_DASHBOARD_USER_NAME", str),
    ("master.dashboard_password", "GORSE_DASHBOARD_PASSWORD", str),
    ("master.dashboard_redacted", "GORSE_DASHBOARD_REDACTED", bool),
    ("master.admin_api_key", "GORSE_ADMIN_API_KEY", str),
    ("server.api_key", "GORSE_SERVER_API_KEY", str),
    ("oidc.enable", "GORSE_OIDC_ENABLE", bool),
    ("oidc.issuer", "GORSE_OIDC_ISSUER", str),
    ("oidc.client_id", "GORSE_OIDC_CLIENT_ID", str),
    ("oidc.client_secret", "GORSE_OIDC_CLIENT_SECRET", str),
    ("oidc.redirect_url", "GORSE_OIDC_REDIRECT_URL", str),
    ("blob.uri", "GORSE_BLOB_URI", str),
]


def _env_value(s: str, target: type):
    if target is bool:
        return s.strip().lower() in ("1", "true", "yes", "on")
    if target is int:
        return int(s)
    return s


def apply_env_overrides(raw: dict, environ=None) -> dict:
    """Overlay GORSE_* environment variables onto a raw config dict."""
    import os

    environ = os.environ if environ is None else environ
    for key, env, target in _ENV_BINDINGS:
        if env in environ:
            parts = key.split(".")
            d = raw
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = _env_value(environ[env], target)
    return raw


def load_config(path: str | Path, env: bool = True) -> Config:
    """Load + validate a TOML config file, then overlay GORSE_* environment
    variables (gorse: config.LoadConfig — viper file + BindEnv)."""
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    if env:
        raw = apply_env_overrides(_normalize_keys(raw))
    cfg = _from_dict(Config, raw)
    cfg.validate()
    return cfg


def default_config(env: bool = True) -> Config:
    """Config with defaults only, plus GORSE_* env overrides (the no
    ``--config`` path of the node binaries)."""
    raw = apply_env_overrides({}) if env else {}
    cfg = _from_dict(Config, raw)
    cfg.validate()
    return cfg


class ConfigWatcher:
    """Hot reload: watch the file's mtime with a debounce and invoke
    callbacks with the re-validated config (gorse: fsnotify watcher with
    1s debounce, master/master.go:174-268)."""

    def __init__(self, path: str | Path, on_change: Callable[[Config], None], interval: float = 1.0) -> None:
        self.path = Path(path)
        self.on_change = on_change
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._mtime = self.path.stat().st_mtime if self.path.exists() else 0.0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                mtime = self.path.stat().st_mtime
            except FileNotFoundError:
                continue
            if mtime != self._mtime:
                self._mtime = mtime
                time.sleep(0.2)  # debounce partial writes
                try:
                    cfg = load_config(self.path)
                except Exception as e:
                    logger.error("config reload failed: %s", e)
                    continue
                logger.info("config reloaded from %s", self.path)
                self.on_change(cfg)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
