"""Blob store for model artifacts (copy of gorse_tpu/storage/blob.py): POSIX
directories keyed by name, each a directory of npz/json written by a
model's ``save``."""

from __future__ import annotations

import shutil
import time
from pathlib import Path


class BlobStore:
    """POSIX blob store; blobs are directories keyed by name (model
    artifacts keyed by millisecond id)."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> Path:
        p = (self.root / name).resolve()
        root = self.root.resolve()
        # is_relative_to, not a string-prefix check: /var/blobs-evil would
        # pass startswith("/var/blobs")
        if p != root and not p.is_relative_to(root):
            raise ValueError(f"blob name escapes store root: {name!r}")
        return p

    def create(self, name: str) -> Path:
        """Return a writable directory path for a new blob."""
        p = self.path(name)
        p.mkdir(parents=True, exist_ok=True)
        return p

    def open(self, name: str) -> Path:
        p = self.path(name)
        if not p.exists():
            raise FileNotFoundError(f"blob {name!r} not found")
        return p

    def exists(self, name: str) -> bool:
        return self.path(name).exists()

    def list(self) -> list[str]:
        return sorted(p.name for p in self.root.iterdir() if p.is_dir())

    def remove(self, name: str) -> None:
        p = self.path(name)
        if p.exists():
            shutil.rmtree(p)

    def flush(self, name: str) -> None:
        """Publish a blob written under ``create(name)``. POSIX blobs are
        already durable; object-store backends would upload here."""

    def ping(self) -> bool:
        return self.root.is_dir()

    def close(self) -> None:
        pass

    @staticmethod
    def new_model_id() -> str:
        """Millisecond-timestamp model id."""
        return str(int(time.time() * 1000))
