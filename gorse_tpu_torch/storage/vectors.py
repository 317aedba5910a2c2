"""Vector store: named collections with top-k similarity queries (port of
gorse_tpu/storage/vectors.py).

Collections of (id, vector) rows with add/delete/query-top-k and their
metadata (dimension, distance, quantization). The master keeps the CF item
factors here. Quantization is native, the card being the quantized vector
database:

- ``sq``: per-row affine uint8 codes, scored by the SQ kernels
  (``ops/topk.sq_topk`` on a :class:`~gorse_tpu_torch.ops.topk.PreparedSQ`);
- ``pq``: product quantization, ``bits`` per dimension becoming
  ``d * bits / 8`` subquantizers with k-means codebooks trained at the first
  query (``ops/topk.pq_topk``);
- ``rq``: a shared seeded rotation, then per-row ``bits``-bit affine codes
  (``ops/topk.rq_topk``).

Raw f32 rows (sq: the codes) are the durable rows; the encoded tables are
query caches, stamped with the collection's version, built outside the lock
and published only if no write landed meanwhile.

Routes, by collection size: with 1,024 rows or more an sq collection serves
through the SQ kernels, and a pq or rq one decodes, recompresses to 8-bit sq
and serves through the same kernels. Smaller sq collections, pq, rq and the
unquantized collections take the reference's XLA formulations (plain
PyTorch). On the CPU the kernels' plain versions run in their place, which
is what lets the CPU tests hold the kernel route against the reference's
Pallas route.

Distances: ``dot`` (default) | ``cosine`` (rows normalized at ingest) |
``euclidean`` (scores are negative distances, larger = closer).
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
import zlib

import numpy as np
import torch

from .. import resolve_device
from ..ops import topk
from .types import Score

DISTANCES = ("dot", "cosine", "euclidean")
QUANTIZATIONS = ("", "sq", "pq", "rq")
_PQ_BITS = (1, 2, 4, 8)   # bits/dimension -> x32..x4 compression
_RQ_BITS = (1, 2, 4)
_PQ_TRAIN_ROWS = 4096     # k-means sample cap
_PQ_ITERS = 10
_KERNEL_ROWS = 1024       # collections at least this large serve through the kernels


@dataclasses.dataclass
class CollectionInfo:
    name: str
    dimension: int
    distance: str = "dot"
    quantization: str = ""
    bits: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _quantize_sq(vec: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Per-row affine scalar quantization: v ~= minv + scale * codes, with a
    Python-float (f64) scale."""
    lo, hi = float(vec.min()), float(vec.max())
    scale = (hi - lo) / 255.0 if hi > lo else 1.0
    codes = np.clip(np.rint((vec - lo) / scale), 0, 255).astype(np.uint8)
    return codes, scale, lo


def _quantize_sq_rows(matrix: np.ndarray):
    """:func:`_quantize_sq` of every row of an f32 ``matrix`` at once, bit
    for bit: the scale in f64 as the reference's Python floats, applied in
    f32 as numpy applies a Python float to an f32 array."""
    lo = matrix.min(axis=1)
    lo64, hi64 = lo.astype(np.float64), matrix.max(axis=1).astype(np.float64)
    scale = np.where(hi64 > lo64, (hi64 - lo64) / 255.0, 1.0)
    codes = np.clip(
        np.rint((matrix - lo[:, None]) / scale.astype(np.float32)[:, None]), 0, 255
    ).astype(np.uint8)
    return codes, scale, lo


def _pq_subspaces(dimension: int, bits: int) -> int:
    """bits/original-dim -> number of 8-bit subquantizers."""
    m = dimension * bits // 8
    if dimension * bits % 8 or m < 1 or dimension % m:
        raise ValueError(
            f"pq bits {bits} incompatible with dimension {dimension}"
        )
    return m


def _device_serving_enabled(n_rows: int) -> bool:
    """Collections of 1,024 rows or more serve through the SQ kernels (on
    the CPU, their plain versions)."""
    return n_rows >= _KERNEL_ROWS


def _sq_recompress(matrix: np.ndarray):
    """Vectorized per-row 8-bit affine quantization of a decoded table, with
    an f32 scale (the pq/rq serving decode-cache). Returns (codes, scale,
    minv); callers keep their own norms2."""
    lo = matrix.min(axis=1).astype(np.float32)
    hi = matrix.max(axis=1).astype(np.float32)
    scale = np.where(hi > lo, (hi - lo) / 255.0, 1.0).astype(np.float32)
    codes = np.clip(
        np.rint((matrix - lo[:, None]) / scale[:, None]), 0, 255
    ).astype(np.uint8)
    return codes, scale, lo


def _train_pq(matrix: np.ndarray, m: int, seed: int = 0) -> np.ndarray:
    """K-means codebooks ([m, 256, ds]) for ``matrix``'s m subspaces."""
    n, d = matrix.shape
    ds = d // m
    rng = np.random.default_rng(seed)
    sample = matrix[rng.permutation(n)[:_PQ_TRAIN_ROWS]]
    codebooks = np.empty((m, 256, ds), np.float32)
    for j in range(m):
        sub = np.ascontiguousarray(sample[:, j * ds : (j + 1) * ds])
        cent = sub[rng.integers(0, len(sub), size=256)].astype(np.float32)
        cent += rng.normal(scale=1e-5, size=cent.shape).astype(np.float32)
        for _ in range(_PQ_ITERS):
            d2 = ((sub[:, None, :] - cent[None]) ** 2).sum(-1)
            assign = d2.argmin(1)
            sums = np.zeros_like(cent)
            counts = np.zeros(256, np.int64)
            np.add.at(sums, assign, sub)
            np.add.at(counts, assign, 1)
            filled = counts > 0
            cent[filled] = sums[filled] / counts[filled, None]
        codebooks[j] = cent
    return codebooks


def _encode_pq(matrix: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Nearest-centroid codes ([n, m] uint8) under trained ``codebooks``."""
    n = matrix.shape[0]
    m, _, ds = codebooks.shape
    codes = np.empty((n, m), np.uint8)
    for j in range(m):
        full = matrix[:, j * ds : (j + 1) * ds]
        cent = codebooks[j]
        for lo in range(0, n, 8192):  # chunk the [n, 256] assignment
            blk = full[lo : lo + 8192]
            codes[lo : lo + 8192, j] = (
                ((blk[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
            )
    return codes


def _rotation(dimension: int, seed: int = 0) -> np.ndarray:
    """Deterministic orthogonal rotation (sign-fixed QR of a Gaussian)."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(dimension, dimension)))
    return (q * np.sign(np.diag(r))[None, :]).astype(np.float32)


def _encode_rq(matrix: np.ndarray, rot: np.ndarray, bits: int):
    """Rotate rows, quantize to ``bits`` with per-row affine params, pack:
    value g of a row sits in byte g // per_byte at bit offset
    (g % per_byte) * bits."""
    n, d = matrix.shape
    levels = (1 << bits) - 1
    r = matrix @ rot.T
    lo = r.min(axis=1)
    hi = r.max(axis=1)
    scale = np.where(hi > lo, (hi - lo) / levels, 1.0).astype(np.float32)
    codes = np.clip(
        np.rint((r - lo[:, None]) / scale[:, None]), 0, levels
    ).astype(np.uint8)
    norms2 = ((lo[:, None] + scale[:, None] * codes.astype(np.float32)) ** 2).sum(1)
    per_byte = 8 // bits
    pad = (-d) % per_byte
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))
    grouped = codes.reshape(n, -1, per_byte).astype(np.uint32)
    shifts = (np.arange(per_byte, dtype=np.uint32) * bits)[None, None, :]
    packed = (grouped << shifts).sum(axis=2).astype(np.uint8)
    return packed, scale, lo.astype(np.float32), norms2.astype(np.float32)


def _decode(info: CollectionInfo, enc: dict, n: int) -> np.ndarray:
    """The pq/rq rows as their codes decode them, f32 ``[n, d]``."""
    if info.quantization == "pq":
        m_sub = enc["codes"].shape[1]
        return enc["codebooks"][
            np.arange(m_sub)[None, :], enc["codes"].astype(np.int64)
        ].reshape(n, -1).astype(np.float32)
    # rq: dequantize in the rotated basis, rotate back
    per_byte = 8 // info.bits
    mask = (1 << info.bits) - 1
    shifts = (np.arange(per_byte, dtype=np.uint8) * info.bits)[None, None, :]
    vals = (enc["packed"][:, :, None] >> shifts) & mask
    codes_r = vals.reshape(n, -1)[:, : info.dimension]
    rot_hat = enc["minv"][:, None] + enc["scale"][:, None] * codes_r
    return (rot_hat @ enc["rot"]).astype(np.float32)


class VectorStore:
    """Abstract vector store."""

    def create_collection(
        self,
        name: str,
        dimensions: int,
        distance: str = "dot",
        quantization: str = "",
        bits: int = 0,
    ) -> None:
        raise NotImplementedError

    def describe_collection(self, name: str) -> dict | None:
        """Collection metadata dict, or None."""
        raise NotImplementedError

    def list_collections(self) -> list[str]:
        raise NotImplementedError

    def has_collection(self, name: str) -> bool:
        return self.describe_collection(name) is not None

    def drop_collection(self, name: str) -> None:
        raise NotImplementedError

    def add(self, collection: str, ids: list[str], vectors: np.ndarray) -> None:
        raise NotImplementedError

    def delete(self, collection: str, ids: list[str]) -> None:
        raise NotImplementedError

    def query(self, collection: str, vectors: np.ndarray, k: int) -> list[list[Score]]:
        """Top-k by the collection's distance for each query vector."""
        raise NotImplementedError

    def ping(self) -> bool:
        return True

    def close(self) -> None:
        pass


class _Collection:
    __slots__ = ("info", "rows", "scales", "mins", "norms2", "encoded", "version")

    def __init__(self, info: CollectionInfo) -> None:
        self.info = info
        # id -> f32 vector (""/pq/rq quantization) or uint8 codes ("sq")
        self.rows: dict[str, np.ndarray] = {}
        self.scales: dict[str, float] = {}
        self.mins: dict[str, float] = {}
        self.norms2: dict[str, float] = {}
        # the encoded query cache, valid iff its "version" == self.version
        # (a write between snapshot and publish bumps the version, so the
        # stale build is discarded instead of masking the write)
        self.encoded: dict | None = None
        self.version = 0


class MemoryVectorStore(VectorStore):
    """In-memory vector store querying on ``device`` (None: the card)."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._collections: dict[str, _Collection] = {}

    def create_collection(self, name, dimensions, distance="dot", quantization="", bits=0) -> None:
        if distance not in DISTANCES:
            raise ValueError(f"unsupported distance {distance!r}")
        if quantization not in QUANTIZATIONS:
            raise ValueError(f"unsupported quantization {quantization!r}")
        if quantization == "sq":
            if bits not in (0, 8):
                raise ValueError(f"sq supports 8 bits, got {bits}")
            bits = 8
        elif quantization == "pq":
            bits = bits or 8
            if bits not in _PQ_BITS:
                raise ValueError(f"pq supports bits {_PQ_BITS}, got {bits}")
            _pq_subspaces(dimensions, bits)  # validate dim/bits combination
        elif quantization == "rq":
            bits = bits or 1
            if bits not in _RQ_BITS:
                raise ValueError(f"rq supports bits {_RQ_BITS}, got {bits}")
        else:
            bits = 0
        with self._lock:
            if name not in self._collections:
                self._collections[name] = _Collection(
                    CollectionInfo(name, dimensions, distance, quantization, bits)
                )

    def describe_collection(self, name):
        c = self._collections.get(name)
        return c.info.to_dict() if c else None

    def list_collections(self) -> list[str]:
        return sorted(self._collections)

    def drop_collection(self, name: str) -> None:
        with self._lock:
            self._collections.pop(name, None)

    def dimensions(self, name: str) -> int:
        return self._collections[name].info.dimension

    def add(self, collection: str, ids: list[str], vectors: np.ndarray) -> None:
        """Upsert rows. The whole batch is normalized and quantized at once,
        bit-equal to the reference's row-by-row ``_quantize_sq``; each
        norms2 is the same per-row f32 dot."""
        with self._lock:
            c = self._collections[collection]
            vectors = np.asarray(vectors, dtype=np.float32)
            assert vectors.shape[1] == c.info.dimension, (
                f"dimension mismatch: {vectors.shape[1]} != {c.info.dimension}"
            )
            ids = list(ids)
            rows = vectors[: len(ids)]
            if c.info.distance == "cosine":
                norms = np.array([float(np.linalg.norm(v)) for v in rows])
                safe = np.where(norms > 0, norms, 1.0).astype(np.float32)
                rows = np.where((norms > 0)[:, None], rows / safe[:, None], rows)
            if c.info.quantization == "sq":
                codes, scale, lo = _quantize_sq_rows(rows)
                approx = lo[:, None] + scale.astype(np.float32)[:, None] * codes.astype(np.float32)
                for i, vid in enumerate(ids):
                    c.rows[vid] = codes[i]
                    c.scales[vid] = float(scale[i])
                    c.mins[vid] = float(lo[i])
                    c.norms2[vid] = float(approx[i] @ approx[i])
            else:
                for i, vid in enumerate(ids):
                    c.rows[vid] = rows[i]
                    c.norms2[vid] = float(rows[i] @ rows[i])
            c.version += 1

    def delete(self, collection: str, ids: list[str]) -> None:
        with self._lock:
            c = self._collections[collection]
            for vid in ids:
                c.rows.pop(vid, None)
                c.scales.pop(vid, None)
                c.mins.pop(vid, None)
                c.norms2.pop(vid, None)
            c.version += 1

    @staticmethod
    def _build_encoded(
        info: CollectionInfo, ids: list[str], matrix: np.ndarray, prev: dict
    ) -> dict:
        """Build the pq/rq query cache from a row snapshot (no lock: callers
        snapshot under the lock, build outside, and publish version-checked).
        The rq rotation is deterministic; pq codebooks are retrained only on
        first build or when the row count has drifted >2x from training."""
        seed = zlib.crc32(info.name.encode())  # deterministic across processes
        if info.quantization == "pq":
            m = _pq_subspaces(info.dimension, info.bits)
            codebooks = prev.get("codebooks")
            trained_rows = prev.get("trained_rows", 0)
            if codebooks is None or not (
                0.5 * trained_rows <= len(ids) <= 2.0 * trained_rows
            ):
                codebooks = _train_pq(matrix, m, seed=seed)
                trained_rows = len(ids)
            codes = _encode_pq(matrix, codebooks)
            vhat = codebooks[np.arange(m)[None, :], codes.astype(np.int64)]
            norms2 = (vhat.reshape(len(ids), -1) ** 2).sum(1).astype(np.float32)
            return {"ids": ids, "codes": codes, "codebooks": codebooks,
                    "trained_rows": trained_rows, "norms2": norms2}
        rot = prev.get("rot")
        if rot is None:
            rot = _rotation(info.dimension, seed=seed)
        packed, scale, lo, norms2 = _encode_rq(matrix, rot, info.bits)
        return {"ids": ids, "packed": packed, "scale": scale,
                "minv": lo, "rot": rot, "norms2": norms2}

    def query(self, collection: str, vectors: np.ndarray, k: int) -> list[list[Score]]:
        dev = self.device
        with self._lock:
            c = self._collections[collection]
            if not c.rows:
                return [[] for _ in range(len(vectors))]
            info = c.info
            ver = c.version
            enc = (
                c.encoded
                if c.encoded is not None and c.encoded.get("version") == ver
                else None
            )
            matrix = prev = scales = mins = norms2 = None
            cached_sq = (
                info.quantization == "sq"
                and isinstance(enc, dict)
                and enc.get("kind") == "sq"
                and _device_serving_enabled(len(c.rows))
            )
            if enc is not None and (info.quantization in ("pq", "rq") or cached_sq):
                ids = enc["ids"]  # the cache serves; no row snapshot needed
            else:
                ids = list(c.rows)
                matrix = np.stack([c.rows[i] for i in ids])
                prev = c.encoded or {}
                if info.quantization == "sq":
                    scales = np.asarray([c.scales[i] for i in ids], dtype=np.float32)
                    mins = np.asarray([c.mins[i] for i in ids], dtype=np.float32)
                norms2 = np.asarray([c.norms2[i] for i in ids], dtype=np.float32)
        if info.quantization in ("pq", "rq") and enc is None:
            # k-means / re-encode outside the lock, from the version-``ver``
            # snapshot; publish only if still current
            enc = self._build_encoded(info, ids, matrix.astype(np.float32), prev)
            enc["version"] = ver
            with self._lock:
                if c.version == ver:
                    c.encoded = enc
        q = np.asarray(vectors, dtype=np.float32)
        if info.distance == "cosine":
            qn = np.linalg.norm(q, axis=1, keepdims=True)
            q = q / np.where(qn > 0, qn, 1.0)
        k_eff = min(k, len(ids))
        if info.quantization in ("pq", "rq") and _device_serving_enabled(len(ids)):
            # serving decode-cache: decode once per collection version,
            # recompress to 8-bit sq and serve through the SQ kernels. The
            # memoized key is attached to ``enc`` outside the lock; readers
            # of a superseded version never see it published.
            prep = enc.get("sq_prepared")
            if prep is None:
                codes8, scale8, min8 = _sq_recompress(_decode(info, enc, len(ids)))
                prep = topk.prepare_sq_items(codes8, scale8, min8, norms2=enc["norms2"],
                                             device=dev)
                enc["sq_prepared"] = prep
            scores, idxs = topk.sq_topk(q, prep, k_top=k_eff, metric=info.distance, device=dev)
        elif info.quantization == "pq":
            scores, idxs = topk.pq_topk(q, enc["codes"], enc["codebooks"], enc["norms2"], k_eff,
                                        metric=info.distance, device=dev)
        elif info.quantization == "rq":
            scores, idxs = topk.rq_topk(q, enc["packed"], enc["scale"], enc["minv"], enc["rot"],
                                        enc["norms2"], k_eff, info.bits, info.dimension,
                                        metric=info.distance, device=dev)
        elif info.quantization == "sq":
            if _device_serving_enabled(len(ids)):
                enc_sq = enc if isinstance(enc, dict) and enc.get("kind") == "sq" else None
                if enc_sq is None:
                    # built from the version-``ver`` snapshot outside the
                    # lock; published only if no write landed meanwhile
                    enc_sq = {
                        "kind": "sq",
                        "ids": ids,
                        "prepared": topk.prepare_sq_items(matrix, scales, mins, norms2=norms2,
                                                          device=dev),
                        "version": ver,
                    }
                    with self._lock:
                        if c.version == ver:
                            c.encoded = enc_sq
                ids = enc_sq["ids"]
                scores, idxs = topk.sq_topk(q, enc_sq["prepared"], k_top=k_eff,
                                            metric=info.distance, device=dev)
            else:
                scores, idxs = topk.sq_topk(q, matrix, scales, mins, k_eff, norms2=norms2,
                                            metric=info.distance, device=dev)
        elif info.distance == "euclidean":
            qt = torch.as_tensor(q, device=dev)
            scores, idxs = topk._xla_top(qt, qt @ torch.as_tensor(matrix, device=dev).T, norms2,
                                         "euclidean", k_eff)
        else:
            scores, idxs = topk.dot_topk_xla(q, matrix, k_eff, device=dev)
        scores, idxs = scores.cpu().numpy(), idxs.cpu().numpy()
        return [
            [Score(id=ids[int(j)], score=float(s)) for s, j in zip(scores[b], idxs[b])]
            for b in range(len(q))
        ]


class SQLiteVectorStore(MemoryVectorStore):
    """SQLite persistence with in-memory query acceleration: vectors are
    durable rows (as given, before normalization or quantization); queries
    run over the cached view."""

    def __init__(self, path: str = ":memory:", device=None) -> None:
        super().__init__(device)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS collections ("
                "name TEXT PRIMARY KEY, dimensions INTEGER,"
                "distance TEXT DEFAULT 'dot', quantization TEXT DEFAULT '', bits INTEGER DEFAULT 0)"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS vectors (collection TEXT, id TEXT, vector TEXT, PRIMARY KEY (collection, id))"
            )
            # migrate pre-quantization schemas in place
            cols = [r[1] for r in self._conn.execute("PRAGMA table_info(collections)")]
            for col, decl in (("distance", "TEXT DEFAULT 'dot'"),
                              ("quantization", "TEXT DEFAULT ''"),
                              ("bits", "INTEGER DEFAULT 0")):
                if col not in cols:
                    self._conn.execute(f"ALTER TABLE collections ADD COLUMN {col} {decl}")
            self._conn.commit()
            # warm the in-memory view (raw f32 rows re-quantize on load)
            for name, dim, distance, quantization, bits in self._conn.execute(
                "SELECT name, dimensions, distance, quantization, bits FROM collections"
            ).fetchall():
                super().create_collection(name, dim, distance or "dot", quantization or "", bits or 0)
                rows = self._conn.execute(
                    "SELECT id, vector FROM vectors WHERE collection = ?", (name,)
                ).fetchall()
                if rows:
                    super().add(name, [vid for vid, _ in rows],
                                np.asarray([json.loads(vec) for _, vec in rows], dtype=np.float32))

    def create_collection(self, name, dimensions, distance="dot", quantization="", bits=0) -> None:
        super().create_collection(name, dimensions, distance, quantization, bits)
        with self._lock:
            self._conn.execute(
                "INSERT OR IGNORE INTO collections VALUES (?, ?, ?, ?, ?)",
                (name, dimensions, distance, quantization,
                 self._collections[name].info.bits),
            )
            self._conn.commit()

    def drop_collection(self, name: str) -> None:
        super().drop_collection(name)
        with self._lock:
            self._conn.execute("DELETE FROM collections WHERE name = ?", (name,))
            self._conn.execute("DELETE FROM vectors WHERE collection = ?", (name,))
            self._conn.commit()

    def add(self, collection: str, ids: list[str], vectors: np.ndarray) -> None:
        super().add(collection, ids, vectors)
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO vectors VALUES (?, ?, ?)",
                [
                    (collection, vid, json.dumps(np.asarray(v, dtype=float).tolist()))
                    for vid, v in zip(ids, np.asarray(vectors))
                ],
            )
            self._conn.commit()

    def delete(self, collection: str, ids: list[str]) -> None:
        super().delete(collection, ids)
        with self._lock:
            self._conn.executemany(
                "DELETE FROM vectors WHERE collection = ? AND id = ?",
                [(collection, vid) for vid in ids],
            )
            self._conn.commit()

    def close(self) -> None:
        self._conn.close()


# backends of the reference not ported yet, by ROADMAP.md item
_NOT_PORTED = {
    "hnsw": "M19 (the native HNSW store)",
    "proxy": "M19 (the proxy store)",
    "qdrant": "M19 (the Qdrant client)",
    "weaviate": "M19 (the Weaviate client)",
    "milvus": "M19 (the Milvus client)",
}


def open_vector_store(url: str, device=None) -> VectorStore:
    """``memory://``, ``sqlite://<path>`` (in memory when empty) and
    ``none://`` (or ""): the backends the port has."""
    if url.startswith("memory://") or url == "memory":
        return MemoryVectorStore(device)
    if url.startswith("sqlite://"):
        return SQLiteVectorStore(url[len("sqlite://"):] or ":memory:", device)
    if url.startswith("none://") or url in ("", "none"):
        from .none import NoVectorStore

        return NoVectorStore()
    scheme = url.split("://", 1)[0]
    if scheme in _NOT_PORTED:
        raise NotImplementedError(
            f"vector store {scheme!r} is not ported yet: ROADMAP.md {_NOT_PORTED[scheme]}"
        )
    raise ValueError(f"unsupported vector store URL {url!r}")
