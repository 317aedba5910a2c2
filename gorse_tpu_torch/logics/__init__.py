"""gorse_tpu_torch.logics (port of gorse_tpu.logics): the serving index and
the recommenders."""

from .cf import MatrixFactorizationIndex
from .item_to_item import ItemToItemConfig, new_item_to_item
from .non_personalized import NonPersonalized, NonPersonalizedConfig
from .recommend import Recommender
from .user_to_user import UserToUser, UserToUserConfig

__all__ = [
    "MatrixFactorizationIndex",
    "ItemToItemConfig",
    "new_item_to_item",
    "NonPersonalized",
    "NonPersonalizedConfig",
    "Recommender",
    "UserToUser",
    "UserToUserConfig",
]
