"""Counter-based BPR sampling (port of gorse_tpu/parallel/sharded.py:38-155).

Threefry-2x32 (20 rounds, the generator behind ``jax.random``) keyed by a
step key and counted by (global user id, column pair), so every user's draws
are independent of how users are laid out. With
``jax_threefry_partitionable`` on (JAX's default), ``jax.random.PRNGKey(s)``
is the key words ``(0, s)`` and ``jax.random.split(key, n)[i]`` is
``threefry2x32(key, (0, i))``, so :func:`prng_key`, :func:`split` and
:func:`raw_step_keys` give the reference's key stream word for word.

Keys are int64 tensors of two 32-bit words. torch has few uint32 ops, so the
arithmetic runs in int64 and every add and rotate is masked to 32 bits.
These are the plain versions; the CUDA sweep (``csrc/bpr.cu``) draws the
same bits inside its kernel. The key stream (:func:`split`,
:func:`raw_step_keys`) runs on the host once an epoch, in numpy uint32:
about a tenth of the time of a torch op per round on a dozen words.
"""

from __future__ import annotations

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


def _threefry2x32_np(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """:func:`threefry2x32` on uint32 numpy arrays (they wrap at 32 bits):
    the key stream's few words without a torch op per round on the host."""
    ks = tuple(np.uint32(k & MASK) for k in (k0, k1, k0 ^ k1 ^ _PARITY))
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


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as key words: ``[0, seed]``."""
    return torch.tensor([0, seed & MASK], dtype=torch.int64)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` on key words: ``[n, 2]`` int64."""
    count = np.arange(n, dtype=np.uint32)
    w0, w1 = _threefry2x32_np(int(key[0]), int(key[1]), np.zeros_like(count), count)
    return torch.from_numpy(np.stack([w0, w1], axis=1).astype(np.int64))


def raw_step_keys(key: torch.Tensor, n_steps: int) -> list[tuple[int, int]]:
    """The per-step key words of an epoch (``_raw_step_keys``)."""
    return [(int(a), int(b)) for a, b in split(key, n_steps).tolist()]


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> f32 in [0, 1): the top 23 bits as the mantissa of a
    number in [1, 2), minus one."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def per_user_uniforms(step_key, uids: torch.Tensor, n: int) -> torch.Tensor:
    """``[U, n]`` uniforms keyed by (step key, global user id, column): one
    threefry block per (user, column pair), its two words columns 2j and
    2j + 1. ``step_key`` may also be an ``[S, 2]`` tensor of key words,
    and then the result is ``[S, U, n]``, row s that of key s."""
    n_pairs = (n + 1) // 2
    x0 = uids.to(torch.int64)[:, None].expand(-1, n_pairs)
    x1 = torch.arange(n_pairs, dtype=torch.int64, device=uids.device)[None, :].expand_as(x0)
    if isinstance(step_key, torch.Tensor) and step_key.dim() == 2:
        k0, k1 = step_key[:, 0, None, None], step_key[:, 1, None, None]
    else:
        k0, k1 = step_key
    w0, w1 = threefry2x32(k0, k1, x0, x1)
    bits = torch.stack([w0, w1], dim=-1)
    return bits_to_uniform(bits.reshape(*bits.shape[:-2], 2 * n_pairs)[..., :n])


# elements of the candidates-against-row comparison that sample_pairs
# holds at once (bools: 256 MiB); more steps are drawn in chunks
_COMPARE_ELEMENTS = 1 << 28


def sample_pairs(
    padded_pos: torch.Tensor,  # [U, L] int32, pad -1
    pos_counts: torch.Tensor,  # [U] int32
    uids: torch.Tensor,  # [U] global user ids
    step_keys,  # S step keys
    n_items: int,
    n_tries: int = 4,
    bits: torch.Tensor | None = None,  # [U, ceil(n_items / 32)] int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_pair` under each of ``step_keys`` at once: ``[S, U]``
    pos and neg, row s bit-equal to ``sample_pair(..., step_keys[s], ...)``
    (the same element-wise arithmetic). The pairs depend on no parameter,
    so an epoch's can be drawn before its sweeps: a few hundred small ops a
    chunk of steps rather than a step."""
    n_users, max_len = padded_pos.shape
    check_bits(bits, n_users, n_items)
    if isinstance(step_keys, torch.Tensor):
        keys = step_keys.to(torch.int64).reshape(-1, 2)
    else:
        keys = torch.tensor([[int(k0), int(k1)] for k0, k1 in step_keys], dtype=torch.int64)
    keys = keys.to(uids.device)
    # a step's bools of the row comparison, or the bitset test's bytes (an
    # int64 word index and an int32 word a candidate) in bools' stead
    per_step = n_users * n_tries * (max_len if bits is None else 16)
    chunk = max(_COMPARE_ELEMENTS // max(per_step, 1), 1)
    rows_of = torch.arange(n_users, device=padded_pos.device)[None, :, None]
    counts = torch.clamp(pos_counts, min=1).to(torch.float32)
    out_pos, out_neg = [], []
    for start in range(0, keys.shape[0], chunk):
        rand = per_user_uniforms(keys[start:start + chunk], uids, 1 + n_tries)  # [S, U, 1 + K]
        slot = (rand[..., 0] * counts).to(torch.int64)
        rows = padded_pos.expand(slot.shape[0], -1, -1)
        picked = torch.gather(rows, 2, torch.clamp(slot, max=max_len - 1)[..., None])[..., 0]
        out_pos.append(torch.where(slot < max_len, torch.clamp(picked, min=0), 0))
        cand = (rand[..., 1:] * float(n_items)).to(torch.int32)  # [S, U, K]
        if bits is None:  # the capped row
            free = ~(padded_pos[None, :, None, :] == cand[..., None]).any(dim=3)  # [S, U, K]
        else:  # the whole positive set: bit c % 32 of word c // 32
            word = bits[rows_of, (cand >> 5).long()]
            free = ((word >> (cand & 31)) & 1) == 0
        first_free = torch.argmax(free.to(torch.int8), dim=2)
        out_neg.append(torch.where(free.any(dim=2),
                                   torch.gather(cand, 2, first_free[..., None])[..., 0],
                                   cand[..., 0]))
    return torch.cat(out_pos).to(torch.int32), torch.cat(out_neg).to(torch.int32)


def sample_pair(
    padded_pos: torch.Tensor,  # [U, L] int32, pad -1
    pos_counts: torch.Tensor,  # [U] int32
    uids: torch.Tensor,  # [U] global user ids
    step_key: tuple[int, int],
    n_items: int,
    n_tries: int = 4,
    bits: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One (pos, neg) pair per user, int32. The positive is slot
    ``int(u0 * max(count, 1))`` of the padded row (0 for a user with no
    positives); the negative is the first of ``n_tries`` candidates
    ``int(u_t * n_items)`` that is not in the user's padded row, else the
    first candidate. Both products are single f32 multiplies. With
    ``bits`` (the int32 view of ``Dataset.positives_bitset``, a row per
    padded row) a candidate is held against the user's whole positive set
    instead of the capped row: the same negatives as the row test on
    uncapped rows."""
    pos, neg = sample_pairs(padded_pos, pos_counts, uids, [step_key], n_items, n_tries, bits)
    return pos[0], neg[0]


def check_bits(bits: torch.Tensor | None, n_users: int, n_items: int) -> None:
    """A positives bitset must be ``[U, ceil(n_items / 32)]`` int32 (the
    bits of the uint32 words); anything else raises."""
    if bits is None:
        return
    words = -(-n_items // 32)
    if bits.dtype != torch.int32:
        raise TypeError(f"bits must be int32 (the uint32 words' bits), is {bits.dtype}")
    if tuple(bits.shape) != (n_users, words):
        raise ValueError(f"bits is {tuple(bits.shape)}, need [{n_users}, {words}]: a row a "
                         f"user, ceil({n_items} / 32) words")
