"""The configuration the port reads (the ``server`` and ``recommend``
sections of gorse_tpu/utils/config.py).

Defaults and ``RecommendConfig.hash()`` are the reference's: the worker
writes that digest into the cache, so both packages must agree on it.
``Config.to_json`` is the master's meta payload. TOML loading, validation
and the other sections are not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from .expression import FeedbackTypeExpression, parse_expressions


@dataclasses.dataclass
class ServerConfig:
    api_key: str = ""
    http_host: str = "127.0.0.1"
    http_port: int = 8087
    clock_error: float = 5.0  # seconds
    epsilon: float = 0.0
    default_n: int = 10
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
    patience: int = 0


@dataclasses.dataclass
class CollaborativeConfig:
    type: str = "none"  # none | mf
    fit_period: float = 60.0  # minutes
    fit_epoch: int = 100
    optimize_period: float = 0.0  # minutes; 0 disables periodic search
    optimize_trials: int = 10
    early_stopping: EarlyStoppingConfig = dataclasses.field(default_factory=EarlyStoppingConfig)
    enable_index: bool = True
    # < 1.0 selects the reference's approximate tier; the port serves exact
    # top-k, which meets any recall target
    index_recall: float = 1.0
    model: str = "bpr"  # bpr | als
    model_search_epoch: int = 10


@dataclasses.dataclass
class RerankerAPIConfig:
    auth_token: str = ""
    model: str = ""
    url: str = ""


@dataclasses.dataclass
class RankerConfig:
    type: str = "none"  # none | fm | llm
    recommenders: list[str] = dataclasses.field(default_factory=lambda: ["latest"])
    cache_expire: float = 120.0  # hours
    fit_period: float = 60.0  # minutes
    fit_epoch: int = 100
    optimize_period: float = 0.0  # minutes
    optimize_trials: int = 10
    query_template: str = ""
    document_template: str = ""
    early_stopping: EarlyStoppingConfig = dataclasses.field(default_factory=EarlyStoppingConfig)
    reranker_api: RerankerAPIConfig = dataclasses.field(default_factory=RerankerAPIConfig)
    lift_threshold: float = 0.0
    prompt: str = ""


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
    columns: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RecommendConfig:
    cache_size: int = 100
    cache_expire: float = 72.0  # hours
    context_size: int = 100
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
        """All configured recommendation sources by full name."""
        out = [f"non-personalized/{e.name}" for e in self.non_personalized]
        out += [f"item-to-item/{e.name}" for e in self.item_to_item]
        out += [f"user-to-user/{e.name}" for e in self.user_to_user]
        out += [f"external/{e.name}" for e in self.external]
        out.append("collaborative")
        out.append("latest")
        return out

    def hash(self) -> str:
        """Digest of exactly the recommenders feeding offline recommendation
        (gorse_tpu/utils/config.py:334): only entries named in
        ranker.recommenders (or all when that list is empty) contribute."""
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
class Config:
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    recommend: RecommendConfig = dataclasses.field(default_factory=RecommendConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str)
