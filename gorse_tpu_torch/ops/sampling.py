"""BPR's two samplers: the reference's one-device sampler and the counter
sampler of its sharded epoch.

The one-device sampler (:func:`_sample_pairs`, port of
gorse_tpu/models/bpr.py:66-104) is what the reference's ``BPR.fit`` draws
on one device, and what the port's fit on one card draws (in ``bpr_epoch``,
K1, and the sampled ``bpr_sweep``, K2, of ``csrc/bpr.cu``). It is built on
``jax.random`` (:mod:`.prng`): a step key splits into ``ks, kn``; row u's
slot is ``randint(ks, (U,), 0, max(count, 1))[u]`` and its candidate t is
element ``u * n_tries + t`` of ``randint(kn, (U, n_tries), 0, n_items)``.

The counter sampler (:func:`sample_pair`, port of
gorse_tpu/parallel/sharded.py:38-155) keys threefry-2x32 by a step key and
counts by (global user id, column pair), so every user's draws are
independent of how users are laid out over shards. The sharded epochs draw
it, as the reference's do.

Both take the positive ``max(row[slot], 0)`` (0 for a slot past the row's L
entries) and the first candidate that is not in the user's rejection set,
else the first candidate; the rejection set is the padded row, or with
``bits`` the user's whole positive set. Step keys come from
:func:`raw_step_keys`, the reference's key stream word for word, computed
on the host in numpy uint32 once an epoch. The kernels split each step key
into its randint keys on the card; the plain versions take them from
:func:`randint_keys`.
"""

from __future__ import annotations

import numpy as np
import torch

from .prng import MASK, prng_key, randint_batch, split, split_batch, threefry2x32  # noqa: F401


def raw_step_keys(key, n_steps: int) -> list[tuple[int, int]]:
    """The per-step key words of an epoch (``jax.random.split(key,
    n_steps)``, the reference's ``_raw_step_keys``)."""
    return [(int(a), int(b)) for a, b in split(key, n_steps).tolist()]


def randint_keys(step_keys) -> np.ndarray:
    """The keys :func:`_sample_pairs` draws with, ``[S, 4, 2]`` uint32: for
    step key s, ``ks, kn = split(step_keys[s])``, then ``split(ks)`` (the
    slot's higher and lower bits) and ``split(kn)`` (the candidates'), the
    two keys inside each ``jax.random.randint``."""
    keys = np.asarray([[int(w) & MASK for w in k] for k in step_keys], np.uint32).reshape(-1, 2)
    ks_kn = split_batch(keys)  # [S, 2, 2]
    return np.concatenate([split_batch(ks_kn[:, 0]), split_batch(ks_kn[:, 1])], axis=1)


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


# elements of the candidates-against-row comparison that the samplers hold
# at once (bools: 256 MiB); more steps are drawn in chunks
_COMPARE_ELEMENTS = 1 << 28


def _chunk_steps(padded_pos: torch.Tensor, n_tries: int, bits) -> int:
    """Steps a chunk: a step's bools of the row comparison, or the bitset
    test's bytes (an int64 word index and an int32 word a candidate) in
    bools' stead, within :data:`_COMPARE_ELEMENTS`."""
    n_users, max_len = padded_pos.shape
    per_step = n_users * n_tries * (max_len if bits is None else 16)
    return max(_COMPARE_ELEMENTS // max(per_step, 1), 1)


def _pairs(padded_pos, slot, cand, bits):
    """Both samplers' pairs from their draws (``slot`` ``[S, U]``, ``cand``
    ``[S, U, K]``, int64): pos ``max(row[slot], 0)``, 0 for a slot past the
    row's L entries; neg the first candidate free of the row, or of
    ``bits`` when given, else candidate 0."""
    max_len = padded_pos.shape[1]
    rows = padded_pos.expand(slot.shape[0], -1, -1)
    picked = torch.gather(rows, 2, torch.clamp(slot, max=max_len - 1)[..., None])[..., 0]
    pos = torch.where(slot < max_len, torch.clamp(picked, min=0), 0)
    if bits is None:  # the capped row
        free = ~(padded_pos[None, :, None, :] == cand[..., None]).any(dim=3)  # [S, U, K]
    else:  # the whole positive set: bit c % 32 of word c // 32
        rows_of = torch.arange(padded_pos.shape[0], device=padded_pos.device)[None, :, None]
        word = bits[rows_of, cand >> 5]
        free = ((word >> (cand & 31).to(word.dtype)) & 1) == 0
    first_free = torch.argmax(free.to(torch.int8), dim=2)
    neg = torch.where(free.any(dim=2), torch.gather(cand, 2, first_free[..., None])[..., 0],
                      cand[..., 0])
    return pos.to(torch.int32), neg.to(torch.int32)


def sample_epoch_pairs(
    padded_pos: torch.Tensor,  # [U, L] int32, pad -1
    pos_counts: torch.Tensor,  # [U] int32
    n_items: int,
    step_keys,  # S step keys
    n_tries: int = 4,
    bits: torch.Tensor | None = None,  # [U, ceil(n_items / 32)] int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_sample_pairs` under each of ``step_keys`` at once: ``[S, U]``
    pos and neg, row s bit-equal to ``_sample_pairs(..., step_keys[s],
    ...)``. U is every padded row, those without positives too."""
    n_users = padded_pos.shape[0]
    check_bits(bits, n_users, n_items)
    inner = randint_keys(step_keys)  # [S, 4, 2]
    dev = padded_pos.device
    counts = torch.clamp(pos_counts.to(torch.int64), min=1)
    chunk = _chunk_steps(padded_pos, n_tries, bits)
    out_pos, out_neg = [], []
    for start in range(0, inner.shape[0], chunk):
        part = inner[start:start + chunk]
        slot = randint_batch(part[:, 0:2], (n_users,), 0, counts, dev)
        cand = randint_batch(part[:, 2:4], (n_users, n_tries), 0, n_items, dev)
        pos, neg = _pairs(padded_pos, slot, cand, bits)
        out_pos.append(pos)
        out_neg.append(neg)
    if not out_pos:
        empty = torch.zeros((0, n_users), dtype=torch.int32, device=dev)
        return empty, empty.clone()
    return torch.cat(out_pos), torch.cat(out_neg)


def _sample_pairs(padded_pos, pos_counts, n_items: int, step_key, n_tries: int = 4,
                  bits=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One (pos, neg) pair a padded row, int32, as the reference's
    one-device epoch draws it (gorse_tpu/models/bpr.py:66-104): ``ks, kn =
    split(step_key)``; the slot is ``randint(ks, (U,), 0, max(count,
    1))[u]``, the candidates row u of ``randint(kn, (U, n_tries), 0,
    n_items)``; the positive ``max(row[slot], 0)``, the negative the first
    candidate free of the row, else the first. With ``bits`` (the int32 view
    of ``Dataset.positives_bitset``) a candidate is held against the user's
    whole positive set."""
    pos, neg = sample_epoch_pairs(padded_pos, pos_counts, n_items, [step_key], n_tries, bits)
    return pos[0], neg[0]


def sample_pairs(
    padded_pos: torch.Tensor,  # [U, L] int32, pad -1
    pos_counts: torch.Tensor,  # [U] int32
    uids: torch.Tensor,  # [U] global user ids
    step_keys,  # S step keys
    n_items: int,
    n_tries: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_pair` under each of ``step_keys`` at once: ``[S, U]``
    pos and neg, row s bit-equal to ``sample_pair(..., step_keys[s], ...)``
    (the same element-wise arithmetic). The pairs depend on no parameter,
    so an epoch's can be drawn before its sweeps: a few hundred small ops a
    chunk of steps rather than a step."""
    if isinstance(step_keys, torch.Tensor):
        keys = step_keys.to(torch.int64).reshape(-1, 2)
    else:
        keys = torch.tensor([[int(k0), int(k1)] for k0, k1 in step_keys], dtype=torch.int64)
    keys = keys.to(uids.device)
    chunk = _chunk_steps(padded_pos, n_tries, None)
    counts = torch.clamp(pos_counts, min=1).to(torch.float32)
    out_pos, out_neg = [], []
    for start in range(0, keys.shape[0], chunk):
        rand = per_user_uniforms(keys[start:start + chunk], uids, 1 + n_tries)  # [S, U, 1 + K]
        slot = (rand[..., 0] * counts).to(torch.int64)
        cand = (rand[..., 1:] * float(n_items)).to(torch.int64)  # [S, U, K]
        pos, neg = _pairs(padded_pos, slot, cand, None)
        out_pos.append(pos)
        out_neg.append(neg)
    return torch.cat(out_pos), torch.cat(out_neg)


def sample_pair(
    padded_pos: torch.Tensor,  # [U, L] int32, pad -1
    pos_counts: torch.Tensor,  # [U] int32
    uids: torch.Tensor,  # [U] global user ids
    step_key: tuple[int, int],
    n_items: int,
    n_tries: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One (pos, neg) pair per user of the counter sampler, int32. The
    positive is slot ``int(u0 * max(count, 1))`` of the padded row (0 for a
    user with no positives); the negative is the first of ``n_tries``
    candidates ``int(u_t * n_items)`` that is not in the user's padded row,
    else the first candidate. Both products are single f32 multiplies. The
    sharded epochs draw it against the capped rows, as the reference's do."""
    pos, neg = sample_pairs(padded_pos, pos_counts, uids, [step_key], n_items, n_tries)
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
