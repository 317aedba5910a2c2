"""The pluggable event recorder (port of gorse_tpu/utils/events.py).

As gorse's common/event (event.go:23-66): an API and a storage recorder
with a no-op default; serve/rest.py records each request through it.
"""

from __future__ import annotations

import threading
import time
from typing import Protocol


class EventRecorder(Protocol):
    def record_api(self, method: str, path: str, status: int, duration: float) -> None: ...

    def record_storage(self, store: str, op: str, duration: float) -> None: ...


class NopRecorder:
    """Default no-op recorder (reference: event.Nop)."""

    def record_api(self, method: str, path: str, status: int, duration: float) -> None:
        pass

    def record_storage(self, store: str, op: str, duration: float) -> None:
        pass


class MemoryRecorder:
    """In-memory recorder for tests/metrics."""

    def __init__(self, keep: int = 1000) -> None:
        self._lock = threading.Lock()
        self.api_events: list[dict] = []
        self.storage_events: list[dict] = []
        self.keep = keep

    def record_api(self, method: str, path: str, status: int, duration: float) -> None:
        with self._lock:
            self.api_events.append(
                {"method": method, "path": path, "status": status,
                 "duration": duration, "timestamp": time.time()}
            )
            self.api_events = self.api_events[-self.keep:]

    def record_storage(self, store: str, op: str, duration: float) -> None:
        with self._lock:
            self.storage_events.append(
                {"store": store, "op": op, "duration": duration, "timestamp": time.time()}
            )
            self.storage_events = self.storage_events[-self.keep:]


_recorder: EventRecorder = NopRecorder()


def set_recorder(recorder: EventRecorder) -> None:
    global _recorder
    _recorder = recorder


def get_recorder() -> EventRecorder:
    return _recorder
