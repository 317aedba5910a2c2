"""``jax.random`` on one device, as the reference's single-device paths call it.

Threefry-2x32 (20 rounds) is the generator behind ``jax.random``. With
``jax_threefry_partitionable`` on (JAX's default), a key is two uint32
words, ``PRNGKey(s)`` is ``(0, s)``, ``split(key, n)[i]`` is
``threefry2x32(key, (0, i))``, and the random bits of element ``i`` (the
flat index) of a draw are the two words of ``threefry2x32(key, (hi(i),
lo(i)))`` xor-ed. On those bits:

- :func:`randint` splits its key in two, takes 32 higher and 32 lower bits
  an element and reduces them modulo ``span = maxval - minval`` through
  ``(hi % span) * m + lo % span`` with ``m = (2^16 % span)^2 % span``, every
  product wrapping at 32 bits, as jax does (for spans above 2^16, ``m``
  wraps to 0 and only the lower bits count);
- :func:`uniform` makes the top 23 bits the mantissa of a number in [1, 2),
  subtracts one, scales, shifts and clamps at ``minval``;
- :func:`normal` is ``sqrt(2) * erfinv(u)`` for ``u`` uniform in
  ``(-1, 1)``, with XLA's f32 ErfInv (``w = -log1p(-x^2)``, Giles' two
  polynomial branches) evaluated op by op in f32, in XLA's order.

Keys are pairs of uint32 words held on the host (Python ints, a numpy or
torch pair); :func:`split` runs in numpy uint32. Draws are torch tensors on
the device asked for. ``random_bits``, ``randint`` and ``uniform`` give
jax's bits exactly; ``normal`` takes its ``log1p`` in f64 rather than from
XLA's own polynomial, so about one entry in a hundred differs from jax's by
an ulp or three.

Torch has few uint32 ops, so the bits are int64 tensors in ``[0, 2^32)``
and every add, rotate and product is masked to 32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Encrypt counter words (x0, x1) under key (k0, k1). Keys are Python
    ints or int64 tensors that broadcast with the counters; everything is in
    [0, 2^32). Returns two int64 tensors of the counters' shape."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for d in range(5):
        for j in range(4):
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, _ROT[(d % 2) * 4 + j]) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & MASK
        x1 = (x1 + ks[(d + 2) % 3] + d + 1) & MASK
    return x0, x1


def _threefry2x32_np(k0, k1, x0: np.ndarray, x1: np.ndarray):
    """:func:`threefry2x32` on uint32 numpy arrays (they wrap at 32 bits),
    keys Python ints or uint32 arrays that broadcast with the counters: the
    key stream's few words without a torch op per round on the host."""
    ks = tuple(np.uint32(k) for k in (k0, k1, np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(_PARITY)))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for d in range(5):
        for j in range(4):
            r = _ROT[(d % 2) * 4 + j]
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(d + 1) % 3]
        x1 = x1 + ks[(d + 2) % 3]
        x1 = x1 + np.uint32(d + 1)
    return x0, x1


def key_words(key) -> tuple[int, int]:
    """A key's two words as Python ints in [0, 2^32)."""
    return int(key[0]) & MASK, int(key[1]) & MASK


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as key words: ``[0, seed]``."""
    return torch.tensor([0, seed & MASK], dtype=torch.int64)


def split(key, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` on key words: ``[n, 2]`` int64."""
    count = np.arange(n, dtype=np.uint32)
    w0, w1 = _threefry2x32_np(*key_words(key), np.zeros_like(count), count)
    return torch.from_numpy(np.stack([w0, w1], axis=1).astype(np.int64))


def split_batch(keys: np.ndarray) -> np.ndarray:
    """``jax.random.split(key)`` of each of ``keys`` ``[S, 2]`` uint32 at
    once: ``[S, 2, 2]`` uint32, row s the two keys of key s."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    count = np.arange(2, dtype=np.uint32)[None, :]
    w0, w1 = _threefry2x32_np(keys[:, :1], keys[:, 1:], np.zeros_like(count), count)
    return np.stack([w0, w1], axis=2)


def _shape(shape) -> tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(int(d) for d in shape)


def _bits(k0, k1, start: int, stop: int, device) -> torch.Tensor:
    """The random bits of flat elements ``[start, stop)`` under key words
    (k0, k1): Python ints, or ``[S, 1]`` int64 tensors for ``[S, stop -
    start]``."""
    i = torch.arange(start, stop, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(k0, k1, i >> 32, i & MASK)
    return w0 ^ w1


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32): element i's bits are the
    xor of the two words of ``threefry2x32(key, (i >> 32, i & MASK))``.
    Returns an int64 tensor of values in [0, 2^32). ``key`` may also be
    ``[S, 2]`` key words, and then the result is ``[S, *shape]``, row s
    that of key s."""
    shape = _shape(shape)
    words = np.asarray(key).astype(np.int64) & MASK
    if words.ndim == 1:
        return _bits(int(words[0]), int(words[1]), 0, math.prod(shape), device).reshape(shape)
    k = torch.from_numpy(words).to(device)
    return _bits(k[:, :1], k[:, 1:], 0, math.prod(shape), device).reshape(-1, *shape)


def _randint_span(minval, maxval, shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """randint's (lower bound, span) an element, int64, broadcast to
    ``shape`` from the trailing axes, as jax's ``broadcast_to_rank`` does;
    the span is 1 where ``maxval <= minval``."""
    lo = torch.as_tensor(minval, dtype=torch.int64, device=device)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=device)
    span = torch.where(hi <= lo, torch.ones_like(hi), hi - lo)
    return torch.broadcast_to(lo, shape), torch.broadcast_to(span, shape)


def _reduce(higher: torch.Tensor, lower: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """jax's ``(hi % span * m + lo % span) % span``, ``m = (2^16 % span)^2 %
    span``, each product and sum wrapping at 32 bits."""
    m = ((65536 % span) ** 2 & MASK) % span
    return (((((higher % span) * m) & MASK) + lower % span) & MASK) % span


def randint_batch(inner, shape, minval, maxval, device=None) -> torch.Tensor:
    """:func:`randint` under many keys at once, given the two keys each one
    splits into (``inner`` ``[S, 2, 2]``, as :func:`split_batch` gives
    them): ``[S, *shape]``, row s ``randint(key_s, shape, minval,
    maxval)``. ``minval`` and ``maxval`` broadcast to ``[S, *shape]``."""
    shape = _shape(shape)
    inner = np.asarray(inner).reshape(-1, 2, 2)
    higher = random_bits(inner[:, 0], shape, device)
    lower = random_bits(inner[:, 1], shape, device)
    lo, span = _randint_span(minval, maxval, higher.shape, higher.device)
    return lo + _reduce(higher, lower, span)


def randint(key, shape, minval, maxval, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): an int64
    tensor of the same values. ``minval`` and ``maxval`` are int32 values
    that broadcast from the trailing axes (a per-row maximum is ``[U, 1]``);
    where ``maxval <= minval`` the span is 1 and the draw is ``minval``.
    Two keys split from ``key`` give each element 32 higher and 32 lower
    bits."""
    inner = split(key).numpy().astype(np.uint32)[None]
    return randint_batch(inner, shape, minval, maxval, device)[0]


def _to_f32(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64 in [0, 2^32)) as the f32 of the same bits."""
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


# elements a draw of uniform / normal takes at once: its ~150 element-wise
# ops then work in the host's caches (about 1 s for 8.8M normals on 8 cores,
# against 4 s in one piece)
_CHUNK = 1 << 20


def _uniform_range(k0: int, k1: int, start: int, stop: int, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    bits = _bits(k0, k1, start, stop, lo.device)
    floats = _to_f32((bits >> 9) | 0x3F800000) - 1.0
    return torch.maximum(lo, fma_f32(floats, hi - lo, lo))


def _draw(key, shape, device, fn) -> torch.Tensor:
    """``fn(k0, k1, start, stop)`` over the flat elements of ``shape`` in
    chunks of :data:`_CHUNK`, as one f32 tensor of ``shape``."""
    shape = _shape(shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    k0, k1 = key_words(key)
    for start in range(0, n, _CHUNK):
        stop = min(start + _CHUNK, n)
        out[start:stop] = fn(k0, k1, start, stop)
    return out.reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a number in [1, 2), minus one, times
    ``maxval - minval`` plus ``minval`` (one rounding: XLA's CPU backend
    fuses the two), at least ``minval``."""
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return _draw(key, shape, device,
                 lambda k0, k1, start, stop: _uniform_range(k0, k1, start, stop, lo, hi))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as the fused multiply-add XLA's
    CPU backend contracts a product and a sum into: the product is exact in
    f64, the sum's rounding error (TwoSum) nudges it one f64 ulp toward the
    exact value, so the rounding to f32 is the exact value's."""
    p = a.double() * b.double()
    c = torch.as_tensor(c, dtype=torch.float64, device=p.device)
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    return torch.where(err != 0, torch.nextafter(s, s + 2 * err), s).float()


# XLA's f32 ErfInv (Giles, "Approximating the erfinv function"): the
# coefficients of its two branches, highest power first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ErfInv op by op: ``w = -log1p(x * -x)``; where ``w < 5``,
    ``w - 2.5`` into the small branch, else ``sqrt(w) - 3`` into the large
    one; ``p = c0``, then ``p = fma(p, w, c_i)`` (XLA's CPU backend fuses
    each product into the sum that follows it); ``p * x``; ``x * inf``
    where ``|x| = 1``. ``log1p`` is taken in f64 and rounded: XLA's own
    polynomial differs from it by an ulp in about one entry in ten, which
    moves the result by at most 3 ulps in about one in a hundred."""
    x = x.to(torch.float32)
    w = -torch.log1p((x * -x).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for c_small, c_large in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        c = torch.where(small, torch.tensor(c_small, dtype=torch.float32, device=x.device),
                        torch.tensor(c_large, dtype=torch.float32, device=x.device))
        p = c if p is None else fma_f32(p, w, c)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): ``sqrt(2) * erfinv(u)``,
    ``u = uniform(key, shape, nextafter(-1, 0), 1)``."""
    lo = torch.tensor(_NORMAL_LO, dtype=torch.float32, device=device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=device)
    sqrt2 = torch.tensor(math.sqrt(2), dtype=torch.float32, device=device)
    return _draw(key, shape, device, lambda k0, k1, start, stop: erfinv_f32(
        _uniform_range(k0, k1, start, stop, lo, hi)) * sqrt2)
