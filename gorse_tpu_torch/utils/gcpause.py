"""A pause of Python's cyclic garbage collector around bulk allocation.

The master's dataset load and the worker's ranking step allocate millions of
small lists, tuples and scores, none of them in a reference cycle. Each
allocation burst triggers collections that walk every live container, the
whole dataset included, so their cost grows with the heap: at the ml-1m
shape they took most of the worker's ranking step. Reference counting still
frees everything at once; only cycles wait for the collector's return.
"""

from __future__ import annotations

import contextlib
import gc


@contextlib.contextmanager
def gc_paused():
    """Disable the cyclic collector for the block; re-enable it after, if
    it was enabled."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()
