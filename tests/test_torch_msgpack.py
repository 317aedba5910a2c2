"""The port's MessagePack codec (gorse_tpu_torch/utils/msgpack.py) against
msgpack 1.x, the reference's (gorse_tpu/serve/dump.py:16), on the CPU.

- The packer's bytes equal ``msgpack.Packer().pack`` (its defaults) on a
  table at every length and range edge (ints at +-2^7, 2^8, 2^15, 2^16,
  2^31, 2^32, 2^63, 2^64 - 1; str and bin lengths 31, 32, 255, 256, 65,535,
  65,536; arrays and maps at 15, 16, 65,535, 65,536; floats including
  -0.0, inf and nan) and on nested values drawn by hypothesis.
- ``msgpack.unpackb`` reads everything the port packs; the port's unpacker
  reads everything msgpack packs, float32 and ext types (which the port
  never packs) included, and a stream of several objects.
- What msgpack refuses, the port refuses: ints out of range, other types,
  map keys other than str and bytes. Exact: no tolerance.
"""

import math

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gorse_tpu_torch.utils import msgpack as pm

EDGES = [0, 1, 2**7 - 1, 2**7, 2**8 - 1, 2**8, 2**15 - 1, 2**15, 2**16 - 1, 2**16, 2**31 - 1,
         2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1]
INTS = sorted(set(EDGES + [-x for x in EDGES if x <= 2**63] + [-x - 1 for x in EDGES
                                                               if x < 2**63] + [-32, -33]))
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]

TABLE = (
    [None, True, False, 0.0, -0.0, 1.5, -2.25e-300, 1e308, float("inf"), float("-inf")]
    + INTS
    + ["x" * n for n in LENGTHS] + ["é" * 20, "日本語", "\x00"]
    + [b"\xff" * n for n in LENGTHS] + [bytearray(b"ab"), memoryview(b"cd")]
    + [[1] * n for n in (0, 1, 15, 16, 65535, 65536)] + [(1, "a"), [[], [[]]]]
    + [{str(i): i for i in range(n)} for n in (0, 1, 15, 16, 65535, 65536)]
    + [{b"k": 1, "s": [None, {"deep": [1.5, b"x"]}]}]
    + [["user", {"UserId": "u1", "Labels": {"a": [1, 2.5, None, True]}, "Comment": "",
                 "Subscribe": None}]]
)


def _ref(value) -> bytes:
    return msgpack.Packer().pack(value)


@pytest.mark.parametrize("value", TABLE, ids=lambda v: f"{type(v).__name__}"
                         f"{len(v) if hasattr(v, '__len__') else repr(v)[:12]}")
def test_packer_bytes_equal_msgpack(value):
    got = pm.Packer().pack(value)
    assert got == _ref(value)
    want = msgpack.unpackb(got)
    back = pm.unpackb(got)
    if isinstance(value, float) and math.isnan(value):
        return
    assert back == want


def test_nan_packs_alike():
    assert pm.packb(float("nan")) == _ref(float("nan"))
    assert math.isnan(pm.unpackb(_ref(float("nan"))))


_leaf = (st.none() | st.booleans()
         | st.integers(-(2**63), 2**64 - 1)
         | st.floats(allow_nan=False)
         | st.text(max_size=300) | st.binary(max_size=300))
_value = st.recursive(
    _leaf,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=20) | st.binary(max_size=8), inner,
                                     max_size=20)),
    max_leaves=60,
)


@settings(max_examples=150, deadline=None)
@given(value=_value)
def test_drawn_values_pack_alike(value):
    got = pm.packb(value)
    assert got == _ref(value)
    assert msgpack.unpackb(got, raw=False) == value
    assert pm.unpackb(got) == value


@settings(max_examples=60, deadline=None)
@given(value=_value, single=st.booleans())
def test_port_reads_what_msgpack_packs(value, single):
    """Whatever msgpack packs (float32 too, with ``use_single_float``)."""
    data = msgpack.packb(value, use_single_float=single)
    assert pm.unpackb(data) == msgpack.unpackb(data)


def test_seeded_rows_and_streams():
    """Rows drawn from a seed with numpy (the dump's shape), one after
    another in a stream, each way."""
    rng = np.random.default_rng(7)
    rows = [["feedback", {"FeedbackType": "like", "UserId": f"u{int(u)}",
                          "ItemId": f"i{int(i)}", "Value": float(v), "Timestamp": float(t)}]
            for u, i, v, t in zip(rng.integers(1000, size=200), rng.integers(5000, size=200),
                                  rng.normal(size=200), rng.uniform(0, 2e9, size=200))]
    stream = b"".join(pm.packb(r) for r in rows)
    assert stream == b"".join(_ref(r) for r in rows)
    assert list(pm.Unpacker(stream)) == rows
    assert list(msgpack.Unpacker(__import__("io").BytesIO(stream), raw=False)) == rows
    assert list(pm.Unpacker(__import__("io").BytesIO(stream))) == rows


@pytest.mark.parametrize("code,data", [(1, b"a"), (2, b"ab"), (3, b"abcd"), (4, b"x" * 8),
                                       (5, b"y" * 16), (6, b"z" * 3), (7, b""),
                                       (8, b"w" * 300), (127, b"q" * 70000)],
                         ids=lambda v: str(v) if isinstance(v, int) else str(len(v)))
def test_ext_types_read(code, data):
    """msgpack's ext types (the port packs none): the port reads them."""
    assert pm.unpackb(_ref(msgpack.ExtType(code, data))) == pm.ExtType(code, data)


@pytest.mark.parametrize("value", [2**64, -(2**63) - 1])
def test_out_of_range_ints_refused(value):
    with pytest.raises(OverflowError):
        _ref(value)
    with pytest.raises(OverflowError):
        pm.packb(value)


@pytest.mark.parametrize("value", [{1, 2}, object(), np.int64(3), 1j])
def test_other_types_refused(value):
    with pytest.raises(TypeError):
        _ref(value)
    with pytest.raises(TypeError):
        pm.packb(value)


def test_non_string_map_keys_refused_on_read():
    data = _ref({1: "a"})
    with pytest.raises(ValueError):
        msgpack.unpackb(data)
    with pytest.raises(ValueError):
        pm.unpackb(data)


def test_truncated_and_trailing_data_refused():
    data = _ref(["abc", 1])
    with pytest.raises(ValueError):
        pm.unpackb(data[:-1])
    with pytest.raises(ValueError):
        pm.unpackb(data + b"\x01")
    with pytest.raises(ValueError):
        list(pm.Unpacker(data[:-2]))
