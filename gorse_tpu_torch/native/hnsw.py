"""ctypes binding for the native HNSW index, hnsw.cpp (port of
gorse_tpu/native/hnsw.py): an approximate nearest-neighbour index for
host-side serving, the store ``hnsw://`` (storage/vectors.py). Falls back
to exact numpy brute force when no C++ toolchain is available (same API,
recall 1.0).

Spaces: ``l2`` (squared L2 distances), ``ip`` (distance = -dot),
``cosine`` (distance = -cosine similarity).
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

from . import build_native

logger = logging.getLogger(__name__)

HNSW_FLAGS = ["-O3", "-march=native", "-std=c++17"]
_SPACES = {"l2": 0, "ip": 1, "cosine": 2}
_lib = None
_tried = False


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build_native("hnsw", HNSW_FLAGS, timeout=180)))
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.hnsw_new.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_uint64]
        lib.hnsw_new.restype = ctypes.c_void_p
        lib.hnsw_free.argtypes = [ctypes.c_void_p]
        lib.hnsw_size.argtypes = [ctypes.c_void_p]
        lib.hnsw_size.restype = ctypes.c_int64
        lib.hnsw_add.argtypes = [ctypes.c_void_p, ctypes.c_int64, i64p, f32p]
        lib.hnsw_mark_deleted.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.hnsw_mark_deleted.restype = ctypes.c_int
        lib.hnsw_search.argtypes = [ctypes.c_void_p, ctypes.c_int64, f32p,
                                    ctypes.c_int, ctypes.c_int, i64p, f32p]
        lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hnsw_save.restype = ctypes.c_int
        lib.hnsw_load.argtypes = [ctypes.c_char_p]
        lib.hnsw_load.restype = ctypes.c_void_p
        _lib = lib
    except Exception as e:  # noqa: BLE001
        logger.warning("native HNSW unavailable (%s); using exact fallback", e)
    return _lib


def native_available() -> bool:
    return _load() is not None


class HNSWIndex:
    """Incremental ANN index over (int64 label, float32 vector) rows."""

    def __init__(self, dim: int, space: str = "ip", m: int = 16,
                 ef_construction: int = 200, seed: int = 0,
                 _handle=None) -> None:
        if space not in _SPACES:
            raise ValueError(f"unknown space {space!r}")
        self.dim, self.space = int(dim), space
        self.m, self.ef_construction = m, ef_construction
        self._lib = _load()
        self._h = _handle
        if self._lib is not None and self._h is None:
            self._h = self._lib.hnsw_new(dim, _SPACES[space], m, ef_construction, seed)
        # exact fallback state
        self._rows: dict[int, np.ndarray] = {}

    # -- mutation -------------------------------------------------------------
    def add(self, labels: np.ndarray, vectors: np.ndarray) -> None:
        labels = np.ascontiguousarray(labels, dtype=np.int64)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        assert vectors.shape == (len(labels), self.dim)
        if self._lib is not None:
            self._lib.hnsw_add(
                self._h, len(labels),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                vectors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return
        for lab, v in zip(labels.tolist(), vectors):
            if self.space == "cosine":
                n = float(np.linalg.norm(v))
                v = v / n if n > 0 else v
            self._rows[lab] = v.copy()

    def mark_deleted(self, label: int) -> bool:
        if self._lib is not None:
            return bool(self._lib.hnsw_mark_deleted(self._h, int(label)))
        return self._rows.pop(int(label), None) is not None

    # -- queries --------------------------------------------------------------
    def search(self, queries: np.ndarray, k: int, ef: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Returns (labels [nq, k] int64 with -1 padding, distances [nq, k])."""
        queries = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.float32)
        nq = len(queries)
        if self._lib is not None:
            out_l = np.full((nq, k), -1, dtype=np.int64)
            out_d = np.full((nq, k), np.inf, dtype=np.float32)
            self._lib.hnsw_search(
                self._h, nq,
                queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                k, max(ef, 2 * k, 32),
                out_l.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out_d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out_l, out_d
        # exact fallback
        out_l = np.full((nq, k), -1, dtype=np.int64)
        out_d = np.full((nq, k), np.inf, dtype=np.float32)
        if not self._rows:
            return out_l, out_d
        labs = np.fromiter(self._rows, dtype=np.int64)
        mat = np.stack([self._rows[int(x)] for x in labs])
        for i, q in enumerate(queries):
            if self.space == "cosine":
                n = float(np.linalg.norm(q))
                q = q / n if n > 0 else q
            if self.space == "l2":
                d = np.sum((mat - q) ** 2, axis=1)
            else:
                d = -(mat @ q)
            top = np.argsort(d)[:k]
            out_l[i, : len(top)] = labs[top]
            out_d[i, : len(top)] = d[top]
        return out_l, out_d

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.hnsw_size(self._h))
        return len(self._rows)

    # -- persistence -----------------------------------------------------------
    def save(self, path: str | os.PathLike) -> None:
        if self._lib is not None:
            if self._lib.hnsw_save(self._h, str(path).encode()) != 0:
                raise IOError(f"cannot save HNSW index to {path}")
            return
        labs = np.fromiter(self._rows, dtype=np.int64)
        mat = (
            np.stack([self._rows[int(x)] for x in labs])
            if len(labs)
            else np.zeros((0, self.dim), np.float32)
        )
        np.savez(path, labels=labs, vectors=mat, dim=self.dim, space=self.space)

    @classmethod
    def load(cls, path: str | os.PathLike, dim: int, space: str = "ip") -> "HNSWIndex":
        lib = _load()
        if lib is not None:
            h = lib.hnsw_load(str(path).encode())
            if not h:
                raise IOError(f"cannot load HNSW index from {path}")
            return cls(dim, space, _handle=h)
        with np.load(f"{path}" if str(path).endswith(".npz") else f"{path}.npz") as z:
            ix = cls(int(z["dim"]), str(z["space"]))
            if len(z["labels"]):
                ix.add(z["labels"], z["vectors"])
            return ix

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.hnsw_free(h)
            self._h = None
