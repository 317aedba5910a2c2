"""Deep memory accounting (copy of gorse_tpu/utils/sizeof.py): recursive
in-memory size of a value tree. Arrays and tensors report their buffer size
(``nbytes``); containers and dataclasses are walked with cycle protection.
"""

from __future__ import annotations

import dataclasses
import sys


def deep_size(obj, _seen: set | None = None) -> int:
    """Approximate total bytes reachable from ``obj``."""
    if _seen is None:
        _seen = set()
    oid = id(obj)
    if oid in _seen:
        return 0
    _seen.add(oid)

    # array types: buffer size dominates, skip attribute walking
    nbytes = getattr(obj, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes

    if isinstance(obj, (str, bytes, bytearray, int, float, bool, type(None))):
        return sys.getsizeof(obj)

    size = sys.getsizeof(obj)
    if isinstance(obj, dict):
        for k, v in obj.items():
            size += deep_size(k, _seen) + deep_size(v, _seen)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            size += deep_size(v, _seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            size += deep_size(getattr(obj, f.name), _seen)
    elif hasattr(obj, "__dict__"):
        size += deep_size(vars(obj), _seen)
    elif hasattr(obj, "__slots__"):
        for slot in obj.__slots__:
            if hasattr(obj, slot):
                size += deep_size(getattr(obj, slot), _seen)
    return size
