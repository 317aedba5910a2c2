"""Native (C++) host-side components, bound by ctypes (port of
gorse_tpu/native/__init__.py).

``fastdata.cpp`` (the libFM and NCF parsers and the CSR build) and
``hnsw.cpp`` (native/hnsw.py) compile at first use with ``g++`` and the
reference's flags into ``build/gorse_tpu_torch/`` at the root of the
checkout, beside the CUDA builds of ops/_build.py, under a name that
digests the source, the flags and what ``-march=native`` resolves to on
this host, so a stale build or one made for another CPU is never loaded.
Every entry point keeps the reference's pure-Python fallback, with its
warning, when ``g++`` fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

logger = logging.getLogger(__name__)

_SRC_DIR = Path(__file__).resolve().parent
FASTDATA_FLAGS = ["-O3", "-march=native"]
_lib = None
_tried = False


def _native_arch() -> str:
    """The target options ``-march=native`` resolves to (g++'s driver
    prints the cc1 command it would run)."""
    out = subprocess.run(["g++", "-march=native", "-###", "-E", "-"], input=b"",
                         capture_output=True, timeout=30)
    return " ".join(line for line in out.stderr.decode().splitlines() if "cc1" in line)


def build_native(name: str, flags: list[str], timeout: float) -> Path:
    """Compile ``native/<name>.cpp`` with ``g++ <flags> -shared -fPIC`` into
    ``build/gorse_tpu_torch/<name>-<digest>.so`` unless that build exists,
    and return its path. A failed build raises."""
    src = _SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(flags).encode())
    digest.update(_native_arch().encode())
    so_path = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *flags, "-shared", "-fPIC", str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, so_path)
    return so_path


def load_native() -> ctypes.CDLL | None:
    """Compile (if needed) and load the native library; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build_native("fastdata", FASTDATA_FLAGS, timeout=120)))
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.libfm_count.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p, i64p]
        lib.libfm_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, f32p, i64p, i32p, f32p, i32p
        ]
        lib.libfm_parse.restype = ctypes.c_int64
        lib.ncf_count.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p]
        lib.ncf_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, i32p]
        lib.ncf_parse.restype = ctypes.c_int64
        lib.build_csr.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int32, i64p, i32p
        ]
        _lib = lib
    except Exception as e:  # noqa: BLE001 — fall back to Python parsing
        logger.warning("native fastdata unavailable (%s); using Python parsers", e)
        _lib = None
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_libfm_bytes(buf: bytes):
    """Parse a libFM buffer natively. Returns (targets f32 [R],
    indptr i64 [R+1], indices i32 [nnz], values f32 [nnz], max_label) or
    None if the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    nnz = ctypes.c_int64()
    lib.libfm_count(buf, len(buf), ctypes.byref(rows), ctypes.byref(nnz))
    r, z = rows.value, nnz.value
    targets = np.empty(r, dtype=np.float32)
    indptr = np.empty(r + 1, dtype=np.int64)
    indices = np.empty(z, dtype=np.int32)
    values = np.empty(z, dtype=np.float32)
    max_label = ctypes.c_int32()
    parsed = lib.libfm_parse(
        buf, len(buf),
        _ptr(targets, ctypes.c_float), _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32), _ptr(values, ctypes.c_float),
        ctypes.byref(max_label),
    )
    assert parsed == r, f"libfm row mismatch: counted {r}, parsed {parsed}"
    # the count pass sizes an upper bound (tokens per line); malformed
    # tokens are skipped by the parser, so trim to the entries written
    written = int(indptr[r])
    return targets, indptr, indices[:written], values[:written], int(max_label.value)


def parse_ncf_bytes(buf: bytes):
    """Parse NCF train/test lines natively. Returns (users i32, items i32)
    or None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    lib.ncf_count(buf, len(buf), ctypes.byref(rows))
    r = rows.value
    users = np.empty(r, dtype=np.int32)
    items = np.empty(r, dtype=np.int32)
    parsed = lib.ncf_parse(buf, len(buf), _ptr(users, ctypes.c_int32), _ptr(items, ctypes.c_int32))
    return users[:parsed], items[:parsed]


def build_csr(rows: np.ndarray, cols: np.ndarray, n_rows: int):
    """Native CSR build; falls back to numpy argsort when unavailable."""
    lib = load_native()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    if lib is None:
        order = np.argsort(rows, kind="stable")
        sorted_cols = cols[order]
        counts = np.bincount(rows, minlength=n_rows)
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, sorted_cols
    indptr = np.empty(n_rows + 1, dtype=np.int64)
    out_cols = np.empty(len(cols), dtype=np.int32)
    lib.build_csr(
        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        len(rows), n_rows,
        _ptr(indptr, ctypes.c_int64), _ptr(out_cols, ctypes.c_int32),
    )
    return indptr, out_cols
