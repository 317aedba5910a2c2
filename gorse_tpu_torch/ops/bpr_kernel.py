"""The BPR pairwise sweep (port of gorse_tpu/ops/bpr_kernel.py).

Two hand-written CUDA kernels (``csrc/bpr.cu``) replace the three TPU
kernels:

- ``bpr_sweep`` in two modes, each behind its own wrapper and launch count:
  :func:`bpr_sweep_sampled` samples one (pos, neg) pair per user inside the
  kernel with the counter-based sampler of :mod:`.sampling` (K2);
  :func:`bpr_sweep_pairs` reads explicit pos / neg / active (K3). Both
  gather q rows from one snapshot, apply the pairwise update of
  ``_pairwise_math`` (``diff = sum(p*qi) - sum(p*qj)``, the TPU kernels'
  order), write the users' new factors, and add the item payloads into a
  delta buffer and the cost into an accumulator.
- :func:`bpr_epoch` (K1): a whole epoch in one cooperative launch, each
  step the sampled sweep (the same device function) and the fold
  ``q += delta; delta = 0``, behind grid barriers.

The sampled sweeps add the rows of the ``HOT_ITEMS`` items most frequent in
the padded rows (:func:`hot_table`, the Zipf head) into shared memory per
thread block and flush them once a sweep.

Each wrapper takes its kernel's plain PyTorch version when its tensors lie
on the CPU and launches the kernel for CUDA tensors (raising if it cannot),
counting launches in ``<wrapper>.launches``.

The reference's entry points keep their names and results, with two
differences in the arguments: the item table is row-major ``[I, k]`` (the
TPU's 128-lane packing is dropped), and sampling takes step key words
(:func:`.sampling.raw_step_keys`) instead of a hardware-PRNG seed, so the
samples are the sharded reference's, bit for bit. Negatives are rejected
against the capped padded rows, as on the reference's Pallas paths: the
kernels scan the first ``count`` entries of a row, so every entry past a
row's count must be -1, as ``Dataset._pad`` builds the rows.

``mm_dtype=torch.bfloat16`` rounds the gathered q rows and the scatter
payloads to bf16 where the TPU kernels cast them; everything else is f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sampling import per_user_uniforms, sample_pair

MAX_K = 256  # factor width the sweep takes (8 elements a lane)
MAX_TRIES = 62  # rejection draws (1 + n_tries words from <= 32 lanes)
HOT_ITEMS = 64  # the Zipf head the sampled sweeps stage: csrc/bpr.cu's HOT_ITEMS
# bpr_epoch_fused's cost-attribution switch (the reference's ``ablate``):
# the stage each value skips; results are wrong by design
ABLATE = {"": 0, "nosample": 1, "samp_nopos": 2, "samp_norej": 3, "nogather": 4,
          "noscatter": 5}


def _ablate_code(ablate: str) -> int:
    if ablate == "scatter_dim0":
        raise ValueError("ablate='scatter_dim0' names the TPU kernel's transposed one-hot "
                         "scatter layout; the port scatters with atomics and has no such layout")
    if ablate not in ABLATE:
        raise ValueError(f"ablate={ablate!r}: one of {sorted(ABLATE)}")
    return ABLATE[ablate]


def step_key_tensor(step_keys, device) -> torch.Tensor:
    """``[n_steps, 2]`` int32: row s holds step s's two key words, each as
    the int32 of the same 32 bits."""
    words = torch.tensor(list(step_keys), dtype=torch.int64).reshape(-1, 2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32).to(device)


def hot_table(padded_pos, n_rows: int, h: int = HOT_ITEMS):
    """The ``h`` items that occur most often in the padded rows, ties to the
    lower index: ``(slot, items)``, ``slot`` ``[n_rows]`` int16 (the item's
    place in ``items``, -1 when not hot) and ``items`` ``[min(h, n_rows)]``
    int32."""
    occ = torch.bincount(padded_pos[padded_pos >= 0].long(), minlength=n_rows)[:n_rows]
    items = torch.sort(occ, descending=True, stable=True).indices[:h]
    slot = torch.full((n_rows,), -1, dtype=torch.int16, device=padded_pos.device)
    slot[items] = torch.arange(items.numel(), dtype=torch.int16, device=padded_pos.device)
    return slot, items.to(torch.int32)


_hot_cache: dict = {}


def _head(padded_pos, n_rows: int) -> tuple:
    """The C entries' (hot_slot, hot_items, n_hot) arguments: hot_table at
    HOT_ITEMS for these rows, computed once for the same rows (a fit's
    epochs share them) and kept alive in the cache. The table only picks
    which rows are staged: the sums are the same whichever it names."""
    key = (padded_pos.data_ptr(), padded_pos._version, tuple(padded_pos.shape),
           str(padded_pos.device), n_rows)
    if key not in _hot_cache:
        _hot_cache.clear()
        _hot_cache[key] = hot_table(padded_pos, n_rows, HOT_ITEMS)
    slot, items = _hot_cache[key]
    return slot.data_ptr(), items.data_ptr(), items.numel()


# ---------------------------------------------------------- plain versions


def _sweep_math(p, q, delta, cost, pos, neg, active, lr, reg, mm_dtype, ablate=""):
    """The sweep's arithmetic in the TPU kernels' op order; adds into
    ``delta`` and ``cost`` in place and returns p_new. ``ablate`` "nogather"
    reads q row 0 for both items, "noscatter" adds nothing into delta."""
    idx_pos, idx_neg = pos.long(), neg.long()
    if ablate == "nogather":
        qi = qj = q[:1].expand(p.shape[0], -1)
    else:
        qi, qj = q[idx_pos], q[idx_neg]
    if mm_dtype == torch.bfloat16:
        qi, qj = qi.bfloat16().float(), qj.bfloat16().float()
    act = active.bool()
    diff = (p * qi).sum(dim=1) - (p * qj).sum(dim=1)
    x = -diff
    c = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))  # logaddexp(0, -diff)
    grad = torch.sigmoid(-diff)[:, None]
    d_pos = lr * (grad * p - reg * qi)
    d_neg = lr * (-grad * p - reg * qj)
    d_pu = lr * (grad * (qi - qj) - reg * p)
    p_new = torch.where(act[:, None], p + d_pu, p)
    if mm_dtype == torch.bfloat16:
        d_pos, d_neg = d_pos.bfloat16().float(), d_neg.bfloat16().float()
    if ablate != "noscatter":
        delta.index_add_(0, idx_pos[act], d_pos[act])
        delta.index_add_(0, idx_neg[act], d_neg[act])
    cost += torch.where(act, c, 0.0).sum()
    return p_new


def bpr_sweep_pairs_plain(p, q, delta, cost, pos, neg, active, lr: float, reg: float,
                          mm_dtype=torch.float32):
    """The sweep's arithmetic in the TPU kernels' op order; adds into
    ``delta`` and ``cost`` in place and returns p_new."""
    return _sweep_math(p, q, delta, cost, pos, neg, active, lr, reg, mm_dtype)


def bpr_sweep_sampled_plain(p, q, delta, cost, padded_pos, pos_counts, step_key, n_items,
                            lr, reg, n_tries=4, mm_dtype=torch.float32):
    uids = torch.arange(p.shape[0], device=p.device)
    pos, neg = sample_pair(padded_pos, pos_counts, uids, step_key, n_items, n_tries)
    p_new = bpr_sweep_pairs_plain(p, q, delta, cost, pos, neg, pos_counts > 0, lr, reg,
                                  mm_dtype)
    return p_new, pos, neg


def sample_pair_ablated(padded_pos, pos_counts, step_key, n_items: int, n_tries: int,
                        ablate: str = ""):
    """The epoch's pairs under ``ablate``, as the reference's lines define
    them (gorse_tpu/ops/bpr_kernel.py:83-93, 361-363): "nosample" pos =
    max(row[0], 0), neg = (pos + 37) % n_items; "samp_nopos" that pos with
    the sampled neg; "samp_norej" the sampled pos with the first candidate;
    otherwise :func:`.sampling.sample_pair`."""
    first = torch.clamp(padded_pos[:, 0], min=0).to(torch.int32)
    if ablate == "nosample":
        return first, ((first + 37) % n_items).to(torch.int32)
    uids = torch.arange(padded_pos.shape[0], device=padded_pos.device)
    pos, neg = sample_pair(padded_pos, pos_counts, uids, step_key, n_items, n_tries)
    if ablate == "samp_nopos":
        pos = first
    elif ablate == "samp_norej":
        u = per_user_uniforms(step_key, uids, 1 + n_tries)
        neg = (u[:, 1] * float(n_items)).to(torch.int32)
    return pos, neg


def bpr_fold_plain(q, delta):
    """The epoch's fold: ``q += delta; delta = 0`` in place; returns q."""
    q.add_(delta)
    delta.zero_()
    return q


def bpr_epoch_plain(p, q, delta, cost, padded_pos, pos_counts, step_keys, n_items: int,
                    lr: float, reg: float, n_tries: int = 4, mm_dtype=torch.float32,
                    ablate: str = "", pairs=None):
    """:func:`bpr_epoch`'s plain version: for each step key a sampled sweep
    from the epoch's running p, then the fold. Updates ``q`` in place, adds
    into ``cost``, leaves ``delta`` zero, fills ``pairs`` ``[2, n_steps, U]``
    with each step's pos and neg when given. Returns p_new."""
    _ablate_code(ablate)
    active = pos_counts > 0
    for s, step_key in enumerate(step_keys):
        pos, neg = sample_pair_ablated(padded_pos, pos_counts, step_key, n_items, n_tries,
                                       ablate)
        if pairs is not None:
            pairs[0, s], pairs[1, s] = pos, neg
        p = _sweep_math(p, q, delta, cost, pos, neg, active, lr, reg, mm_dtype, ablate)
        bpr_fold_plain(q, delta)
    return p


# ---------------------------------------------------------------- kernels


def _lib() -> ctypes.CDLL:
    lib = _build.load("bpr")
    if not getattr(lib, "_gt_typed", False):
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.gt_bpr_sweep.argtypes = [
            i, i, p, p, p, p, p, i, i, p, p, i, u, u, i, i, p, p, p, p, p, f, f, p, p, i, p,
        ]
        lib.gt_bpr_epoch.argtypes = [
            i, p, p, p, p, p, i, i, i, p, p, i, p, i, i, i, p, p, f, f, i, p, p, i, p,
        ]
        lib.gt_bpr_sweep.restype = lib.gt_bpr_epoch.restype = ctypes.c_int
        lib._gt_typed = True
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def _check(tensors: dict, dtype, device) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_factors(p, q, delta, cost, mm_dtype) -> None:
    if p.device.type != "cuda":
        raise ValueError(f"factors on {p.device}: the kernel needs a CUDA device")
    _check({"p": p, "q": q, "delta": delta, "cost": cost}, torch.float32, p.device)
    if p.dim() != 2 or q.dim() != 2 or p.shape[1] != q.shape[1] or delta.shape != q.shape:
        raise ValueError(f"shapes p {tuple(p.shape)}, q {tuple(q.shape)}, "
                         f"delta {tuple(delta.shape)}: need [U, k], [I, k], [I, k]")
    if not 0 < p.shape[1] <= MAX_K:
        raise ValueError(f"k = {p.shape[1]}: the sweep takes 1..{MAX_K}")
    if cost.numel() != 1:
        raise ValueError("cost must hold one f32")
    if mm_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mm_dtype {mm_dtype}: f32 or bf16")


def _check_rows(p, q, padded_pos, pos_counts, n_items: int, n_tries: int) -> None:
    _check({"padded_pos": padded_pos, "pos_counts": pos_counts}, torch.int32, p.device)
    n_users = p.shape[0]
    if padded_pos.dim() != 2 or padded_pos.shape[0] != n_users or pos_counts.shape != (n_users,):
        raise ValueError("padded_pos must be [U, L] and pos_counts [U], one row per user")
    if not 0 < n_items <= q.shape[0] or not 0 < n_tries <= MAX_TRIES:
        raise ValueError(f"n_items {n_items} (table {q.shape[0]}), n_tries {n_tries}")


def bpr_sweep_sampled(p, q, delta, cost, padded_pos, pos_counts, step_key, n_items: int,
                      lr: float, reg: float, n_tries: int = 4, mm_dtype=torch.float32):
    """One sweep over every user with in-kernel sampling. ``step_key`` is a
    step's two key words; user ``u`` draws with counter ``u``.
    ``padded_pos`` ``[U, L]`` holds each user's positives in its first
    ``pos_counts[u]`` entries (every entry when the count exceeds L, as
    :func:`.sampling.sample_pair` reads it) and -1 after them. Returns
    ``(p_new, pos, neg)``; adds the item payloads into ``delta`` ``[I, k]``
    and the cost into ``cost`` ``[1]`` (both f32, in place)."""
    if p.device.type == "cpu":
        return bpr_sweep_sampled_plain(p, q, delta, cost, padded_pos, pos_counts, step_key,
                                       n_items, lr, reg, n_tries, mm_dtype)
    _check_factors(p, q, delta, cost, mm_dtype)
    _check_rows(p, q, padded_pos, pos_counts, n_items, n_tries)
    n_users = p.shape[0]
    p_new = torch.empty_like(p)
    pos = torch.empty((n_users,), dtype=torch.int32, device=p.device)
    neg = torch.empty((n_users,), dtype=torch.int32, device=p.device)
    rc = _lib().gt_bpr_sweep(
        1, int(mm_dtype == torch.bfloat16), p.data_ptr(), p_new.data_ptr(), q.data_ptr(),
        delta.data_ptr(), cost.data_ptr(), n_users, p.shape[1], padded_pos.data_ptr(),
        pos_counts.data_ptr(), padded_pos.shape[1], int(step_key[0]), int(step_key[1]),
        n_items, n_tries, pos.data_ptr(), neg.data_ptr(), None, None, None,
        lr, reg, *_head(padded_pos, q.shape[0]), _stream(p),
    )
    _raise_on(rc, "bpr_sweep (sampled)")
    bpr_sweep_sampled.launches += 1
    return p_new, pos, neg


def bpr_sweep_pairs(p, q, delta, cost, pos, neg, active, lr: float, reg: float,
                    mm_dtype=torch.float32):
    """One sweep over every user given explicit ``pos``, ``neg`` and
    ``active`` ``[U]`` int32, with pos and neg in ``[0, I)``. Returns
    ``p_new``; adds into ``delta`` and ``cost`` in place, as
    :func:`bpr_sweep_sampled`."""
    if p.device.type == "cpu":
        return bpr_sweep_pairs_plain(p, q, delta, cost, pos, neg, active, lr, reg, mm_dtype)
    _check_factors(p, q, delta, cost, mm_dtype)
    _check({"pos": pos, "neg": neg, "active": active}, torch.int32, p.device)
    n_users = p.shape[0]
    if pos.shape != (n_users,) or neg.shape != (n_users,) or active.shape != (n_users,):
        raise ValueError("pos, neg and active must be [U]")
    p_new = torch.empty_like(p)
    rc = _lib().gt_bpr_sweep(
        0, int(mm_dtype == torch.bfloat16), p.data_ptr(), p_new.data_ptr(), q.data_ptr(),
        delta.data_ptr(), cost.data_ptr(), n_users, p.shape[1], None, None, 0, 0, 0,
        q.shape[0], 0, None, None, pos.data_ptr(), neg.data_ptr(), active.data_ptr(),
        lr, reg, None, None, 0, _stream(p),
    )
    _raise_on(rc, "bpr_sweep (pairs)")
    bpr_sweep_pairs.launches += 1
    return p_new


def bpr_epoch(p, q, delta, cost, padded_pos, pos_counts, step_keys, n_items: int, lr: float,
              reg: float, n_tries: int = 4, mm_dtype=torch.float32, ablate: str = "",
              pairs=None):
    """A whole epoch in one cooperative launch: for each step key the
    sampled sweep (as :func:`bpr_sweep_sampled`, from the epoch's running
    p), a grid barrier, the fold ``q += delta; delta = 0``, a grid barrier.
    ``delta`` must be zero on entry and is zero on return; ``q`` is updated
    in place and the cost added into ``cost``. ``pairs``, when given, is
    ``[2, n_steps, U]`` int32 and receives each step's pos and neg.
    Returns p_new. A launch that cannot be cooperative (the grid does not
    fit the card) raises."""
    code = _ablate_code(ablate)
    if p.device.type == "cpu":
        return bpr_epoch_plain(p, q, delta, cost, padded_pos, pos_counts, step_keys, n_items,
                               lr, reg, n_tries, mm_dtype, ablate, pairs)
    _check_factors(p, q, delta, cost, mm_dtype)
    _check_rows(p, q, padded_pos, pos_counts, n_items, n_tries)
    keys = step_key_tensor(step_keys, p.device)
    n_steps, n_users = keys.shape[0], p.shape[0]
    if pairs is not None:
        _check({"pairs": pairs}, torch.int32, p.device)
        if pairs.shape != (2, n_steps, n_users):
            raise ValueError(f"pairs must be [2, {n_steps}, {n_users}]")
    if n_steps == 0:
        return p.clone()
    p_new = torch.empty_like(p)
    rc = _lib().gt_bpr_epoch(
        int(mm_dtype == torch.bfloat16), p.data_ptr(), p_new.data_ptr(), q.data_ptr(),
        delta.data_ptr(), cost.data_ptr(), n_users, p.shape[1], q.shape[0],
        padded_pos.data_ptr(), pos_counts.data_ptr(), padded_pos.shape[1], keys.data_ptr(),
        n_steps, n_items, n_tries, None if pairs is None else pairs[0].data_ptr(),
        None if pairs is None else pairs[1].data_ptr(), lr, reg, code,
        *_head(padded_pos, q.shape[0]), _stream(p),
    )
    _raise_on(rc, "bpr_epoch")
    bpr_epoch.launches += 1
    return p_new


bpr_sweep_sampled.launches = 0
bpr_sweep_pairs.launches = 0
bpr_epoch.launches = 0


# ------------------------------------------------ the reference's entries


def bpr_fused_step(p, q, pos, neg, active, lr: float, reg: float, mm_dtype=torch.float32):
    """One sweep given explicit pairs (K3, ``_fused_kernel``). Returns
    ``(p_new, q_delta [I, k], cost)``."""
    delta = torch.zeros_like(q)
    cost = torch.zeros((1,), dtype=torch.float32, device=p.device)
    p_new = bpr_sweep_pairs(p, q, delta, cost, pos.to(torch.int32), neg.to(torch.int32),
                            active.to(torch.int32), lr, reg, mm_dtype)
    return p_new, delta, cost[0]


def bpr_fully_fused_step(p, q, padded_pos, pos_counts, step_key, n_items: int, lr: float,
                         reg: float, mm_dtype=torch.float32, n_tries: int = 4):
    """One sweep with in-kernel sampling (K2, ``_fully_fused_kernel``).
    Returns ``(p_new, q_delta [I, k], cost, pos, neg)``."""
    delta = torch.zeros_like(q)
    cost = torch.zeros((1,), dtype=torch.float32, device=p.device)
    p_new, pos, neg = bpr_sweep_sampled(p, q, delta, cost, padded_pos, pos_counts, step_key,
                                        n_items, lr, reg, n_tries, mm_dtype)
    return p_new, delta, cost[0], pos, neg


def bpr_epoch_fused(p, q, padded_pos, pos_counts, step_keys, n_items: int, lr: float,
                    reg: float, mm_dtype=torch.bfloat16, n_tries: int = 4, ablate: str = ""):
    """A whole epoch (K1, ``_epoch_resident_kernel``) in one launch of
    :func:`bpr_epoch`. ``q`` is updated in place (it is the epoch's only
    item table). Returns ``(p_new, q, cost)``. ``ablate`` is the reference's
    cost-attribution switch (:data:`ABLATE`; "scatter_dim0", the TPU's
    transposed scatter, raises): the results of an ablated epoch are wrong
    by design."""
    delta = torch.zeros_like(q)
    cost = torch.zeros((1,), dtype=torch.float32, device=p.device)
    p = bpr_epoch(p, q, delta, cost, padded_pos, pos_counts, step_keys, n_items, lr, reg,
                  n_tries, mm_dtype, ablate)
    return p, q, cost[0]
