"""gorse_tpu_torch.utils (port of gorse_tpu.utils): the config, feedback
type expressions and safe expressions."""

from .config import Config, ConfigWatcher, load_config
from .expression import FeedbackTypeExpression, match_any, parse_expressions
from .safe_expr import SafeExpression

__all__ = [
    "Config",
    "ConfigWatcher",
    "load_config",
    "FeedbackTypeExpression",
    "match_any",
    "parse_expressions",
    "SafeExpression",
]
