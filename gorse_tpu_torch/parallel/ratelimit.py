"""Token-bucket rate limiters for LLM APIs (copy of
gorse_tpu/parallel/ratelimit.py).

Covers the reference's common/parallel/ratelimit.go (:18-44): requests-per-
minute and tokens-per-minute buckets guarding OpenAI calls. ``take(n)``
returns the duration to sleep before proceeding (the reference's
ratelimit.Take contract).
"""

from __future__ import annotations

import threading
import time


class TokenBucket:
    """Classic token bucket: ``capacity`` units refilled per ``period``."""

    def __init__(self, capacity: int, period: float = 60.0) -> None:
        self.capacity = max(capacity, 1)
        self.period = period
        self.tokens = float(self.capacity)
        self.updated = time.monotonic()
        self._lock = threading.Lock()

    def take(self, n: int = 1) -> float:
        """Reserve ``n`` units; returns seconds to wait before proceeding."""
        with self._lock:
            now = time.monotonic()
            rate = self.capacity / self.period
            self.tokens = min(self.capacity, self.tokens + (now - self.updated) * rate)
            self.updated = now
            self.tokens -= n
            if self.tokens >= 0:
                return 0.0
            return -self.tokens / rate

    def wait(self, n: int = 1) -> None:
        delay = self.take(n)
        if delay > 0:
            time.sleep(delay)


class RateLimiters:
    """The four OpenAI limiters (reference: parallel.InitLimiters)."""

    def __init__(
        self,
        chat_rpm: int = 60,
        chat_tpm: int = 100000,
        embedding_rpm: int = 600,
        embedding_tpm: int = 1000000,
    ) -> None:
        self.chat_requests = TokenBucket(chat_rpm)
        self.chat_tokens = TokenBucket(chat_tpm)
        self.embedding_requests = TokenBucket(embedding_rpm)
        self.embedding_tokens = TokenBucket(embedding_tpm)
