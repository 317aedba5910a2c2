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
  polynomial branches) evaluated op by op in f32, in XLA's order, its
  ``log1p`` XLA's own (:func:`log1p_f32`).

Keys are pairs of uint32 words held on the host (Python ints, a numpy or
torch pair); :func:`split` runs in numpy uint32. Draws are torch tensors on
the device asked for. ``random_bits``, ``randint``, ``uniform`` and
``normal`` give jax's bits exactly.

XLA's CPU backend contracts a product and the sum it feeds into one fused
multiply-add wherever the product has no other use, and runs with
subnormal inputs read as zero. :func:`fma_f32` rounds such a pair once;
:func:`log1p_f32` reads subnormal inputs as zero.

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


# elements a draw of uniform / normal takes at once: its ~600 element-wise
# passes (each fma_f32 over f64 temporaries) then work in the host's caches
# rather than its memory (tools/init_draw_probe.py times other sizes)
_CHUNK = 1 << 18


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


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as the fused multiply-add XLA's
    CPU backend contracts a product and a sum into. ``a`` is a tensor, ``b``
    and ``c`` tensors or Python floats, all of f32 values. The product is
    exact in f64; the sum is rounded to odd, and a sum rounded to odd in 53
    bits rounds to 24 as the exact value does. Rounding to odd is the sum
    rounded toward zero with its last bit set where it is inexact: TwoSum
    gives the nearest sum ``s`` and its error, and where the error's sign is
    not ``s``'s the nearest rounded away from zero, so the bits of ``s``
    (sign and magnitude) step one down (integer ops only)."""
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    c = c.double() if torch.is_tensor(c) else c
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    inexact = (err != 0).long()
    bits = s.view(torch.int64)
    away = ((err.view(torch.int64) ^ bits) >> 63) * inexact  # -1 where rounded away
    return ((bits + away) | inexact).view(torch.float64).float()


_FLT_MIN = 2.0**-126
# XLA's f32 log (Cephes): the polynomial in r = m - 1, m the mantissa in
# [sqrt(1/2), sqrt(2)), and the two parts of ln 2
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.707106781186547524
# XLA's f32 log1p (Cephes) below |x| = sqrt(2) - 1: x - x^2 / 2 + x^3 N(x) /
# D(x), the coefficients highest power first (D's leading 1 apart)
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _log_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` op by op: ``y`` (at least ``FLT_MIN``) split into a
    mantissa ``m`` in [0.5, 1) and an exponent ``e``; below sqrt(1/2) ``m``
    doubles and ``e`` drops by one; ``r = m - 1``; the Cephes polynomial in
    three Horner parts joined by ``r^3``; ``r - r^2 / 2 + poly + e ln 2``
    with ln 2 in two parts. Each product that feeds one sum is fused with
    it, as XLA contracts them. NaN below 0, -inf at 0, inf at inf."""
    yc = torch.clamp(y, min=_FLT_MIN)
    bits = yc.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).float() + 1.0
    low = m < _f32(_SQRT_HALF)
    e = e - low.float()
    r = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    r2 = r * r
    r3 = r2 * r
    p = [_f32(c) for c in _LOG_P]
    y0 = fma_f32(fma_f32(r, p[0], p[1]), r, p[2])
    y1 = fma_f32(fma_f32(r, p[3], p[4]), r, p[5])
    y2 = fma_f32(fma_f32(r, p[6], p[7]), r, p[8])
    poly = fma_f32(fma_f32(y0, r3, y1), r3, y2)
    out = fma_f32(-r2, 0.5, r) + fma_f32(poly, r3, e * _f32(_LOG_Q1))
    out = fma_f32(e, _f32(_LOG_Q2), out)
    out = torch.where(y == 0, -math.inf, out)
    out = torch.where((y < 0) | torch.isnan(y), math.nan, out)
    return torch.where(y == math.inf, math.inf, out)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p`` on its CPU backend, op by op: where ``|x| <
    sqrt(2) - 1`` Cephes' rational form ``x + (x^2 * -0.5 + x * x^2 *
    N(x) / D(x))`` (Horner steps and the last product fused), elsewhere
    :func:`_log_f32` of ``x + 1``. A subnormal ``x`` is read as a zero of
    its sign."""
    x = x.to(torch.float32)
    x = torch.where(x.abs() < _FLT_MIN, x * 0.0, x)
    x2 = x * x
    den = x + _f32(_LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = fma_f32(den, x, _f32(c))
    num = torch.full_like(x, _f32(_LOG1P_NUM[0]))
    for c in _LOG1P_NUM[1:]:
        num = fma_f32(num, x, _f32(c))
    small = x + fma_f32(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _f32(_LOG1P_SMALL), small, _log_f32(x + 1.0))


# XLA's f32 ErfInv (Giles, "Approximating the erfinv function"): the
# coefficients of its two branches, highest power first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ErfInv op by op: ``w = -log1p(x * -x)`` (:func:`log1p_f32`);
    where ``w < 5``, ``w - 2.5`` into the small branch, else ``sqrt(w) - 3``
    into the large one (the root taken in f64 and rounded: torch's f32
    root on the CPU is not the correctly rounded one XLA's is); ``p = c0``,
    then ``p = fma(p, w, c_i)`` (XLA's CPU backend fuses each product into
    the sum that follows it); ``p * x``; ``x * inf`` where ``|x| = 1``."""
    x = x.to(torch.float32)
    w = -log1p_f32(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
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
