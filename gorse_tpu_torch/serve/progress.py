"""Hierarchical progress spans (copy of gorse_tpu/serve/progress.py): named
task spans with counts and status; workers push theirs to the master."""

from __future__ import annotations

import contextlib
import threading
import time


class Span:
    def __init__(self, name: str, total: int = 0) -> None:
        self.name = name
        self.total = total
        self.count = 0
        self.status = "running"
        self.start_time = time.time()
        self.finish_time: float | None = None
        self.error: str = ""

    def add(self, n: int = 1) -> None:
        self.count += n

    def end(self, error: str = "") -> None:
        self.finish_time = time.time()
        self.status = "failed" if error else "complete"
        self.error = error

    def to_dict(self) -> dict:
        return {
            "Name": self.name,
            "Total": self.total,
            "Count": self.count,
            "Status": self.status,
            "StartTime": self.start_time,
            "FinishTime": self.finish_time,
            "Error": self.error,
        }


class ProgressTracker:
    def __init__(self, keep: int = 100) -> None:
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._remote: dict[str, list[dict]] = {}
        self.keep = keep

    def start(self, name: str, total: int = 0) -> Span:
        span = Span(name, total)
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self.keep:
                self._spans = self._spans[-self.keep:]
        return span

    @contextlib.contextmanager
    def span(self, name: str, total: int = 0):
        s = self.start(name, total)
        try:
            yield s
            s.end()
        except Exception as e:
            s.end(error=str(e))
            raise

    def push_remote(self, node_id: str, spans: list[dict]) -> None:
        """Worker -> master progress push."""
        with self._lock:
            self._remote[node_id] = spans

    def list(self) -> list[dict]:
        with self._lock:
            out = [s.to_dict() for s in self._spans]
            for node_id, spans in self._remote.items():
                for s in spans:
                    s = dict(s)
                    s["Node"] = node_id
                    out.append(s)
        return out
