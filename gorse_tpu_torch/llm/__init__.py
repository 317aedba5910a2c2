"""gorse_tpu_torch.llm (copy of gorse_tpu.llm): the stdlib OpenAI client and
its in-process mock server."""

from .client import OpenAIClient, parse_array_from_completion, strip_think
from .mock import MockOpenAIServer, hash_embedding

__all__ = [
    "OpenAIClient",
    "parse_array_from_completion",
    "strip_think",
    "MockOpenAIServer",
    "hash_embedding",
]
