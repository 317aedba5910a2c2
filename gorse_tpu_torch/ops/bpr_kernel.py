"""The BPR pairwise sweep (port of gorse_tpu/ops/bpr_kernel.py).

Two hand-written CUDA kernels (``csrc/bpr.cu``) replace the three TPU
kernels:

- ``bpr_sweep`` in two modes, each behind its own wrapper and launch count:
  :func:`bpr_sweep_sampled` samples one (pos, neg) pair per user inside the
  kernel with the counter-based sampler of :mod:`.sampling` (K2's body, and
  K1's per step); :func:`bpr_sweep_pairs` reads explicit pos / neg / active
  (K3). Both gather q rows from one snapshot, apply the pairwise update of
  ``_pairwise_math`` (``diff = sum(p*qi) - sum(p*qj)``, the TPU kernels'
  order), write the users' new factors, and add the item payloads into a
  delta buffer and the cost into an accumulator.
- :func:`bpr_fold`: ``q += delta; delta = 0``, the sweep boundary.

Each wrapper takes its kernel's plain PyTorch version when its tensors lie
on the CPU and launches the kernel for CUDA tensors (raising if it cannot),
counting launches in ``<wrapper>.launches``.

The reference's entry points keep their names and results, with two
differences in the arguments: the item table is row-major ``[I, k]`` (the
TPU's 128-lane packing is dropped), and sampling takes step key words
(:func:`.sampling.raw_step_keys`) instead of a hardware-PRNG seed, so the
samples are the sharded reference's, bit for bit. Negatives are rejected
against the capped padded rows, as on the reference's Pallas paths.

``mm_dtype=torch.bfloat16`` rounds the gathered q rows and the scatter
payloads to bf16 where the TPU kernels cast them; everything else is f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sampling import sample_pair

MAX_K = 256  # factor width the sweep takes (8 elements a lane)
MAX_TRIES = 62  # rejection draws (1 + n_tries words from <= 32 lanes)


# ---------------------------------------------------------- plain versions


def bpr_sweep_pairs_plain(p, q, delta, cost, pos, neg, active, lr: float, reg: float,
                          mm_dtype=torch.float32):
    """The sweep's arithmetic in the TPU kernels' op order; adds into
    ``delta`` and ``cost`` in place and returns p_new."""
    idx_pos, idx_neg = pos.long(), neg.long()
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
    delta.index_add_(0, idx_pos[act], d_pos[act])
    delta.index_add_(0, idx_neg[act], d_neg[act])
    cost += torch.where(act, c, 0.0).sum()
    return p_new


def bpr_sweep_sampled_plain(p, q, delta, cost, padded_pos, pos_counts, step_key, n_items,
                            lr, reg, n_tries=4, mm_dtype=torch.float32):
    uids = torch.arange(p.shape[0], device=p.device)
    pos, neg = sample_pair(padded_pos, pos_counts, uids, step_key, n_items, n_tries)
    p_new = bpr_sweep_pairs_plain(p, q, delta, cost, pos, neg, pos_counts > 0, lr, reg,
                                  mm_dtype)
    return p_new, pos, neg


def bpr_fold_plain(q, delta):
    q.add_(delta)
    delta.zero_()
    return q


# ---------------------------------------------------------------- kernels


def _lib() -> ctypes.CDLL:
    lib = _build.load("bpr")
    if not getattr(lib, "_gt_typed", False):
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.gt_bpr_sweep.argtypes = [
            i, i, p, p, p, p, p, i, i, p, p, i, u, u, i, i, p, p, p, p, p, f, f, p,
        ]
        lib.gt_bpr_fold.argtypes = [p, p, ctypes.c_longlong, p]
        lib.gt_bpr_sweep.restype = lib.gt_bpr_fold.restype = ctypes.c_int
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


def bpr_sweep_sampled(p, q, delta, cost, padded_pos, pos_counts, step_key, n_items: int,
                      lr: float, reg: float, n_tries: int = 4, mm_dtype=torch.float32):
    """One sweep over every user with in-kernel sampling. ``step_key`` is a
    step's two key words; user ``u`` draws with counter ``u``.
    Returns ``(p_new, pos, neg)``; adds the item payloads into ``delta``
    ``[I, k]`` and the cost into ``cost`` ``[1]`` (both f32, in place)."""
    if p.device.type == "cpu":
        return bpr_sweep_sampled_plain(p, q, delta, cost, padded_pos, pos_counts, step_key,
                                       n_items, lr, reg, n_tries, mm_dtype)
    _check_factors(p, q, delta, cost, mm_dtype)
    _check({"padded_pos": padded_pos, "pos_counts": pos_counts}, torch.int32, p.device)
    n_users = p.shape[0]
    if padded_pos.dim() != 2 or padded_pos.shape[0] != n_users or pos_counts.shape != (n_users,):
        raise ValueError("padded_pos must be [U, L] and pos_counts [U], one row per user")
    if not 0 < n_items <= q.shape[0] or not 0 < n_tries <= MAX_TRIES:
        raise ValueError(f"n_items {n_items} (table {q.shape[0]}), n_tries {n_tries}")
    p_new = torch.empty_like(p)
    pos = torch.empty((n_users,), dtype=torch.int32, device=p.device)
    neg = torch.empty((n_users,), dtype=torch.int32, device=p.device)
    rc = _lib().gt_bpr_sweep(
        1, int(mm_dtype == torch.bfloat16), p.data_ptr(), p_new.data_ptr(), q.data_ptr(),
        delta.data_ptr(), cost.data_ptr(), n_users, p.shape[1], padded_pos.data_ptr(),
        pos_counts.data_ptr(), padded_pos.shape[1], int(step_key[0]), int(step_key[1]),
        n_items, n_tries, pos.data_ptr(), neg.data_ptr(), None, None, None,
        lr, reg, _stream(p),
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
        lr, reg, _stream(p),
    )
    _raise_on(rc, "bpr_sweep (pairs)")
    bpr_sweep_pairs.launches += 1
    return p_new


def bpr_fold(q, delta):
    """``q += delta; delta = 0`` in place (the sweep boundary); returns q."""
    if q.device.type == "cpu":
        return bpr_fold_plain(q, delta)
    if q.device.type != "cuda":
        raise ValueError(f"q on {q.device}: the kernel needs a CUDA device")
    _check({"q": q, "delta": delta}, torch.float32, q.device)
    if delta.shape != q.shape:
        raise ValueError("delta must have q's shape")
    rc = _lib().gt_bpr_fold(q.data_ptr(), delta.data_ptr(), q.numel(), _stream(q))
    _raise_on(rc, "bpr_fold")
    bpr_fold.launches += 1
    return q


bpr_sweep_sampled.launches = 0
bpr_sweep_pairs.launches = 0
bpr_fold.launches = 0


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
                    reg: float, mm_dtype=torch.bfloat16, n_tries: int = 4):
    """A whole epoch (K1, ``_epoch_resident_kernel``): for each step key a
    sampled sweep, then the fold of its deltas into q. ``q`` is updated in
    place (it is the epoch's only item table). Returns ``(p_new, q, cost)``."""
    delta = torch.zeros_like(q)
    cost = torch.zeros((1,), dtype=torch.float32, device=p.device)
    for step_key in step_keys:
        p, _, _ = bpr_sweep_sampled(p, q, delta, cost, padded_pos, pos_counts, step_key,
                                    n_items, lr, reg, n_tries, mm_dtype)
        bpr_fold(q, delta)
    return p, q, cost[0]
