"""AFM, the factorization machine with attention towers over dense
embedding columns (port of gorse_tpu/models/fm.py): the CTR ranker.

Forward, per sample with sparse features (idx, x) and dense embedding
columns e_c:

    vx  = sum_d  x_d * V[idx_d]                                   # [k]
    out = w.x + 0.5 * sum_k(vx^2 - sum_d V[idx_d]^2 x_d^2) + b
          + sum_c  vx . E_c(softmax(relu(e_c Wc + bc) Hc) * e_c)

Pad slots carry index 0 with value 0 and add nothing, to the output or to
``V[0]``'s gradient. The reference computes this in XLA (no Pallas kernel);
the port computes it with PyTorch tensor ops and autograd on the model's
device.

Kept from the reference because they decide the model:
- the batches: the padded rows cut in row order (no shuffle) into
  ``ceil(n / B)`` batches, the last padded with zero-weight rows; the loss
  ``sum(bce * w) / max(sum w, 1)`` in the stable form;
- the optimizers: optax's ``add_decayed_weights(reg)`` then
  ``scale_by_adam()`` and ``scale(-lr)`` is :class:`OptaxAdam`, optax's
  f32 arithmetic as XLA evaluates it (L2 into the gradient of every
  parameter, ``b`` and the tower biases included; every row of ``v`` and
  ``w`` updated each step, since their moments decay); ``sgd`` is
  ``torch.optim.SGD`` with ``weight_decay=reg`` and no momentum;
- the evaluation cadence, the divergence break and early stopping; the
  epoch's loss stays on the card and is read only on evaluated epochs;
- with a mesh of more than one shard, the data-parallel epoch of
  parallel/sharded.py, its batch rounded up to a multiple of the shard
  count, or with ``shard_table`` the table-sharded epoch of
  parallel/catalog.py.

The init is the reference's: ``kv, kw, *katt = split(PRNGKey(seed), 2 + 3 *
max(len(embedding_dims), 1))``, each table ``jax.random.normal`` under its
own key (:mod:`..ops.prng`, drawn on the host, so a fit on the card and one
on the CPU start equal).
``afm_params_from_numpy`` carries the reference's parameters (the
``params.npz`` layout) into the port's module; ``load`` uses it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import itertools
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..data.ctr import CTRDataset, PaddedCTR
from ..ops.metrics import classification_metrics
from ..ops.prng import fma_f32, normal, prng_key, split
from .params import (
    ADAM,
    AUTO_SCALE,
    BATCH_SIZE,
    INIT_MEAN,
    INIT_STDDEV,
    LR,
    N_EPOCHS,
    N_FACTORS,
    OPTIMIZER,
    REG,
    FitConfig,
    Params,
)
from .scaler import AutoScaler, apply_scalers, fit_auto_scalers

logger = logging.getLogger(__name__)

# a tower's arrays in params.npz, in the order a fitted reference model
# saves them (its parameter tree comes back from jit with sorted keys)
TOWER_KEYS = ("eb", "ew", "h", "w", "wb")


@dataclasses.dataclass
class CTRScore:
    """Classification fit result."""

    auc: float
    accuracy: float
    precision: float
    recall: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class AttentionTower(nn.Module):
    """One embedding column's attention and encoder: ``w`` [dim, k], ``wb``
    [k], ``h`` [k, dim], ``ew`` [dim, k], ``eb`` [k]."""

    def __init__(self, dim: int, n_factors: int) -> None:
        super().__init__()
        self.w = nn.Parameter(torch.zeros(dim, n_factors))
        self.wb = nn.Parameter(torch.zeros(n_factors))
        self.h = nn.Parameter(torch.zeros(n_factors, dim))
        self.ew = nn.Parameter(torch.zeros(dim, n_factors))
        self.eb = nn.Parameter(torch.zeros(n_factors))


class AFMParams(nn.Module):
    """The AFM's parameters: ``v`` [F, k], ``w`` [F, 1], ``b`` (0-d) and an
    attention tower per embedding column."""

    def __init__(self, n_features: int, n_factors: int, embedding_dims) -> None:
        super().__init__()
        self.v = nn.Parameter(torch.zeros(n_features, n_factors))
        self.w = nn.Parameter(torch.zeros(n_features, 1))
        self.b = nn.Parameter(torch.zeros(()))
        self.att = nn.ModuleList(AttentionTower(dim, n_factors) for dim in embedding_dims)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """The ``params.npz`` layout: ``b``, ``v``, ``w``, ``att{c}_{key}``."""
        flat = {name: getattr(self, name).detach().cpu().numpy() for name in ("b", "v", "w")}
        for c, tower in enumerate(self.att):
            for key in TOWER_KEYS:
                flat[f"att{c}_{key}"] = getattr(tower, key).detach().cpu().numpy()
        return flat


def afm_params_from_numpy(flat, device=None) -> AFMParams:
    """An ``AFMParams`` holding ``flat``'s arrays (the ``params.npz``
    layout, as either package saves it) as f32 on ``device``."""
    n_towers = next(c for c in itertools.count() if f"att{c}_w" not in flat)
    v = np.asarray(flat["v"])
    dims = [int(np.asarray(flat[f"att{c}_w"]).shape[0]) for c in range(n_towers)]
    params = AFMParams(v.shape[0], v.shape[1], dims)
    with torch.no_grad():
        for name in ("b", "v", "w"):
            getattr(params, name).copy_(torch.from_numpy(np.array(flat[name], np.float32)))
        for c, tower in enumerate(params.att):
            for key in TOWER_KEYS:
                getattr(tower, key).copy_(
                    torch.from_numpy(np.array(flat[f"att{c}_{key}"], np.float32)))
    return params.to(resolve_device(device))


def afm_forward_rows(params: AFMParams, v: torch.Tensor, w: torch.Tensor, values: torch.Tensor,
                     embeddings) -> torch.Tensor:
    """AFM forward from gathered factor rows: ``v`` [B, D, k], ``w`` [B, D,
    1], ``values`` [B, D]; ``params`` supplies ``b`` and the towers."""
    x = values[..., None]  # [B, D, 1]
    vx = (v * x).sum(dim=1)  # [B, k]
    square_sum = ((v * v) * (x * x)).sum(dim=1)  # [B, k]
    interaction = 0.5 * (vx * vx - square_sum).sum(dim=1)  # [B]
    linear = (w[..., 0] * values).sum(dim=1)  # [B]
    out = linear + interaction + params.b
    for tower, e in zip(params.att, embeddings):
        scores = torch.relu(e @ tower.w + tower.wb) @ tower.h  # [B, dim]
        attended = torch.softmax(scores, dim=-1) * e
        enc = attended @ tower.ew + tower.eb  # [B, k]
        out = out + (vx * enc).sum(dim=1)
    return out


def afm_forward(params: AFMParams, indices: torch.Tensor, values: torch.Tensor,
                embeddings=()) -> torch.Tensor:
    """AFM forward pass. ``indices``/``values`` [B, D]; ``embeddings`` one
    [B, dim] tensor per tower."""
    return afm_forward_rows(params, params.v[indices], params.w[indices], values, embeddings)


def bce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each logit's binary cross-entropy, in the stable form. ``relu`` and
    ``abs`` give the reference's slope ``-t`` at a logit of exactly zero
    (jax's ``maximum`` gives its tie 0.5 and ``abs`` 1 there; ``clamp``'s
    slope of 1 at its bound would make it ``1 - t``)."""
    return torch.relu(logits) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    sample_weight: torch.Tensor) -> torch.Tensor:
    """Weighted mean binary cross-entropy on logits."""
    return (bce_terms(logits, targets) * sample_weight).sum() / torch.clamp(
        sample_weight.sum(), min=1.0)


@functools.cache
def _powf():
    """The C library's f32 ``powf``: XLA's CPU backend calls it for an f32
    power."""
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").powf
    fn.restype, fn.argtypes = ctypes.c_float, (ctypes.c_float, ctypes.c_float)
    return fn


def bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count`` in f32 as XLA computes it: ``powf`` of
    the f32 decay and the count converted to f32, a result below 2^-126
    flushed to zero (XLA's CPU backend flushes subnormals), then ``1 -`` it
    in f32."""
    power = np.float32(_powf()(np.float32(decay), np.float32(count)))
    if abs(power) < np.float32(2.0**-126):
        power = np.float32(0.0)
    return float(np.float32(1.0) - power)


def _f32(x: float) -> float:
    return float(np.float32(x))


class OptaxAdam(torch.optim.Optimizer):
    """optax's ``chain(add_decayed_weights(reg), scale_by_adam(b1, b2, eps),
    scale(-lr))`` and ``apply_updates``, as the reference's jitted epoch
    evaluates them in f32 on XLA's CPU backend, op by op:

        g  = fma(p, reg, grad)                   decayed gradient
        mu = fma(g, 1 - b1, mu * b1)             first moment, f32
        nu = fma(nu, b2, g * g * (1 - b2))       second moment, f32
        u  = mu / (bc1 * (sqrt(nu / bc2) + eps)) bc = 1 - b^count, f32
        p  = fma(u, -lr, p)

    ``fma`` rounds once (XLA contracts each product into the sum it feeds,
    :func:`..ops.prng.fma_f32`); XLA rewrites optax's ``(mu / bc1) /
    (sqrt(nu / bc2) + eps)`` into the one division above; the root is taken
    in f64 and rounded, which is the correctly rounded f32 root; ``count``
    is an int32 that stops at 2^31 - 1 and the bias corrections are
    :func:`bias_correction`'s. Dense, as optax: every entry's moments decay
    every step, and a parameter without a gradient takes a zero one.

    The parameters of each device become views of one flat buffer when the
    optimizer is built (their values kept), and a step copies their
    gradients into it (``torch._foreach_copy_``) and updates it whole, so a
    step's launches do not grow with the number of tensors. ``state[p]``
    holds ``mu`` and ``nu``, views of the flat moments."""

    def __init__(self, params, lr: float, reg: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
        super().__init__(params, {"lr": lr, "reg": reg, "b1": b1, "b2": b2, "eps": eps})
        self.count = 0
        self._flat = []
        by_device: dict = {}
        for p in self.param_groups[0]["params"]:
            by_device.setdefault(p.device, []).append(p)
        for dev, ps in by_device.items():
            sizes = [p.numel() for p in ps]
            buf = torch.zeros(4, sum(sizes), dtype=torch.float32, device=dev)
            views = [[x.view(p.shape) for x, p in zip(row.split(sizes), ps)] for row in buf]
            with torch.no_grad():
                torch._foreach_copy_(views[0], ps)
            for p, view, mu, nu in zip(ps, views[0], views[2], views[3]):
                p.data = view
                self.state[p] = {"mu": mu, "nu": nu}
            # the bias corrections as 0-d tensors on the device: a division
            # by a Python number on the card multiplies by its reciprocal
            bc = torch.ones(2, dtype=torch.float32, device=dev)
            self._flat.append((ps, buf, views[1], bc))

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        b1, b2 = group["b1"], group["b2"]
        self.count = min(self.count + 1, 2**31 - 1)
        bc1, bc2 = bias_correction(b1, self.count), bias_correction(b2, self.count)
        for ps, buf, g_views, bc in self._flat:
            p, g, mu, nu = buf
            have = [(v, q.grad) for v, q in zip(g_views, ps) if q.grad is not None]
            if len(have) < len(ps):
                g.zero_()
            if have:
                torch._foreach_copy_([v for v, _ in have], [x for _, x in have])
            bc[0].fill_(bc1)
            bc[1].fill_(bc2)
            g.copy_(fma_f32(p, _f32(group["reg"]), g))
            mu.copy_(fma_f32(g, _f32(1 - b1), mu * _f32(b1)))
            nu.copy_(fma_f32(nu, _f32(b2), g * g * _f32(1 - b2)))
            den = torch.sqrt((nu / bc[1]).double()).float().add_(_f32(group["eps"])).mul_(bc[0])
            p.copy_(fma_f32(mu / den, _f32(-group["lr"]), p))
        return None


def make_optimizer(name: str, params, lr: float, reg: float) -> torch.optim.Optimizer:
    """``adam``: optax's decay + scale_by_adam + scale(-lr)
    (:class:`OptaxAdam`); anything else (``sgd``): decay + scale(-lr)."""
    if name == ADAM:
        return OptaxAdam(params, lr=lr, reg=reg)
    return torch.optim.SGD(params, lr=lr, momentum=0.0, weight_decay=reg)


def afm_gradients(params: AFMParams, batches, s: int) -> torch.Tensor:
    """Batch ``s``'s loss (``_batch``'s [S, B, ...] tensors) and its
    gradients into every parameter's ``grad``; returns the loss."""
    indices, values, targets, weights, embeddings = batches
    for p in params.parameters():
        p.grad = None
    logits = afm_forward(params, indices[s], values[s], [e[s] for e in embeddings])
    loss = bce_with_logits(logits, targets[s], weights[s])
    loss.backward()
    return loss.detach()


def train_epoch(params: AFMParams, optimizer: torch.optim.Optimizer, batches) -> torch.Tensor:
    """One pass over ``batches`` (``_batch``'s [S, B, ...] tensors), a
    step a batch. Returns the summed loss as a 0-d tensor on the device."""
    losses = []
    for s in range(batches[0].shape[0]):
        losses.append(afm_gradients(params, batches, s))
        optimizer.step()
    return torch.stack(losses).sum()


class AFM:
    """Attention factorization machine, with the reference's defaults."""

    name = "afm"
    # inference chunk: bounds the [chunk, D, k] gather of one forward pass
    PREDICT_CHUNK = 65536

    def __init__(self, params: Params | dict | None = None, device=None) -> None:
        self.params = Params(params or {})
        self.device = resolve_device(device)
        p = self.params
        self.n_factors = p.get_int(N_FACTORS, 16)
        self.n_epochs = p.get_int(N_EPOCHS, 50)
        self.lr = p.get_float(LR, 0.001)
        self.reg = p.get_float(REG, 0.0002)
        self.init_mean = p.get_float(INIT_MEAN, 0.0)
        self.init_stddev = p.get_float(INIT_STDDEV, 0.01)
        self.optimizer_name = p.get_string(OPTIMIZER, ADAM)
        self.batch_size = p.get_int(BATCH_SIZE, 1024)
        self.auto_scale = p.get_bool(AUTO_SCALE, True)
        self.model_params: AFMParams | None = None
        self.index = None
        self.scalers: dict[int, AutoScaler] = {}
        self.embedding_dims: list[int] = []
        self.num_dimension = 0

    def is_fitted(self) -> bool:
        return self.model_params is not None

    def _init_params(self, n_features: int, embedding_dims: list[int], seed: int) -> AFMParams:
        """The reference's init (gorse_tpu/models/fm.py:177-196): ``kv, kw,
        *katt = split(PRNGKey(seed), 2 + 3 * max(len(embedding_dims), 1))``;
        ``v`` and ``w`` ``init_mean + init_stddev * normal`` under ``kv``
        and ``kw``; tower c's ``w``, ``h``, ``ew`` ``0.01 * normal`` under
        ``katt[3c : 3c + 3]``, its biases 0."""
        kv, kw, *katt = split(prng_key(seed), 2 + 3 * max(len(embedding_dims), 1))
        flat = {
            "b": np.zeros((), np.float32),
            "v": (self.init_mean
                  + self.init_stddev * normal(kv, (n_features, self.n_factors))).numpy(),
            "w": (self.init_mean + self.init_stddev * normal(kw, (n_features, 1))).numpy(),
        }
        for c, dim in enumerate(embedding_dims):
            k1, k2, k3 = katt[3 * c:3 * c + 3]
            flat[f"att{c}_w"] = (0.01 * normal(k1, (dim, self.n_factors))).numpy()
            flat[f"att{c}_wb"] = np.zeros(self.n_factors, np.float32)
            flat[f"att{c}_h"] = (0.01 * normal(k2, (self.n_factors, dim))).numpy()
            flat[f"att{c}_ew"] = (0.01 * normal(k3, (dim, self.n_factors))).numpy()
            flat[f"att{c}_eb"] = np.zeros(self.n_factors, np.float32)
        return afm_params_from_numpy(flat, self.device)

    def _make_optimizer(self) -> torch.optim.Optimizer:
        return make_optimizer(self.optimizer_name, self.model_params.parameters(), self.lr,
                              self.reg)

    def _batch(self, padded: PaddedCTR, batch_size: int):
        """The padded arrays as [S, B, ...] tensors on the device, cut in row
        order, the last batch filled with zero-weight rows."""
        n = padded.indices.shape[0]
        s = max((n + batch_size - 1) // batch_size, 1)
        pad = s * batch_size - n

        def to_batches(x, dtype=None):
            t = torch.as_tensor(x)
            if pad:
                t = torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
            return t.to(self.device, dtype).reshape((s, batch_size) + t.shape[1:])

        weights = torch.ones(n, dtype=torch.float32)
        return (
            to_batches(padded.indices, torch.long),
            to_batches(padded.values),
            to_batches(padded.targets),
            to_batches(weights),
            tuple(to_batches(e) for e in padded.embeddings),
        )

    def _on_device(self, padded: PaddedCTR) -> PaddedCTR:
        """``padded``'s indices, values, targets and embeddings as tensors on
        the device (``valid`` stays on the host)."""
        return PaddedCTR(
            indices=torch.as_tensor(padded.indices, device=self.device).long(),
            values=torch.as_tensor(padded.values, device=self.device),
            valid=padded.valid,
            targets=torch.as_tensor(padded.targets, device=self.device),
            embeddings=[torch.as_tensor(e, device=self.device) for e in padded.embeddings],
        )

    def _setup(self, train: CTRDataset, test: CTRDataset, config: FitConfig):
        """What :meth:`fit` does before its epochs: the index, the embedding
        dims and width, the scalers, the init from ``config.seed``, and
        ``(batches, test rows on the device, n_features)``; with a mesh of
        more than one shard the batch is rounded up to a multiple of the
        shards."""
        self.index = train.index
        self.embedding_dims = list(train.embedding_dims)
        self.num_dimension = max(train.max_dimension(), test.max_dimension())
        n_features = train.num_features()
        if self.auto_scale:
            self.scalers = fit_auto_scalers(train.features)
        self.model_params = self._init_params(n_features, self.embedding_dims, config.seed)

        train_pad = train.padded(self.num_dimension)
        test_pad = test.padded(self.num_dimension)
        if self.scalers:
            train_pad.values = apply_scalers(
                train_pad.indices, train_pad.values, self.scalers, train_pad.valid
            )
            test_pad.values = apply_scalers(
                test_pad.indices, test_pad.values, self.scalers, test_pad.valid
            )
        mesh = config.mesh
        batch_size = self.batch_size
        if mesh is not None and mesh.size > 1:
            # data-parallel: the batch rounded up to a multiple of the shards
            batch_size = -(-batch_size // mesh.size) * mesh.size
        return self._batch(train_pad, batch_size), self._on_device(test_pad), n_features

    def fit(self, train: CTRDataset, test: CTRDataset, config: FitConfig | None = None) -> CTRScore:
        config = config or FitConfig(verbose=1)
        batches, test_pad, n_features = self._setup(train, test, config)
        score = self._evaluate(test_pad)  # epoch 0, on the init
        run, to_dense = self._epochs(config, batches, n_features)
        history = [(0, score.auc)]
        logger.info("fit afm 0/%d AUC=%.4f", self.n_epochs, score.auc)
        for epoch in range(1, self.n_epochs + 1):
            t0 = time.time()
            cost = run()
            if (config.verbose and epoch % config.verbose == 0) or epoch == self.n_epochs:
                to_dense()
                score = self._evaluate(test_pad)
                history.append((epoch, score.auc))
                cost = float(cost)
                logger.info(
                    "fit afm %d/%d fit=%.2fs loss=%.4f AUC=%.4f Acc=%.4f",
                    epoch, self.n_epochs, time.time() - t0, cost, score.auc, score.accuracy,
                )
                if not np.isfinite(cost) or not np.isfinite(score.auc):
                    logger.warning("model diverged (lr=%g)", self.lr)
                    break
                if config.patience > 0 and epoch > config.patience:
                    best_epoch = max(history, key=lambda t: t[1])[0]
                    if best_epoch <= epoch - config.patience:
                        logger.info("early stopping at epoch %d (best %d)", epoch, best_epoch)
                        break
        to_dense()
        return self._evaluate(test_pad)

    def _epochs(self, config: FitConfig, batches, n_features: int):
        """The fit's epoch: ``(run, to_dense)``, ``run()`` one epoch (its
        summed loss), ``to_dense()`` brings the parameters back into
        ``model_params``. A mesh of more than one shard takes the
        data-parallel epoch (the batch sharded, the gradients summed over
        the shards, one optimizer step), with ``shard_table`` the
        table-sharded one (its drops in ``table_drop_count``); otherwise
        :func:`train_epoch` on the model's device."""
        mesh = config.mesh
        if mesh is None or mesh.size == 1:
            optimizer = self._make_optimizer()
            return (lambda: train_epoch(self.model_params, optimizer, batches)), lambda: None
        from ..parallel.sharded import make_data_parallel_afm_epoch, shard_afm_batches

        shards = shard_afm_batches(mesh, batches)
        if not config.shard_table:
            optimizer = self._make_optimizer()
            epoch = make_data_parallel_afm_epoch(mesh)
            return (lambda: epoch(self.model_params, optimizer, *shards)), lambda: None
        from ..parallel.catalog import make_sharded_afm_epoch, shard_afm_params, unshard_afm_params

        sharded = shard_afm_params(mesh, self.model_params)
        optimizer = make_optimizer(self.optimizer_name, sharded.leaves(), self.lr, self.reg)
        epoch = make_sharded_afm_epoch(mesh)
        self.table_drop_count = None

        def run():
            loss, self.table_drop_count = epoch(sharded, optimizer, *shards)
            return loss

        def to_dense():
            self.model_params = unshard_afm_params(mesh, sharded, n_features, self.n_factors,
                                                   self.device)

        return run, to_dense

    def _evaluate(self, test_pad: PaddedCTR) -> CTRScore:
        logits = self.predict_padded(test_pad.indices, test_pad.values, test_pad.embeddings)
        m = classification_metrics(torch.as_tensor(test_pad.targets, device=self.device), logits)
        return CTRScore(
            auc=float(m["AUC"]),
            accuracy=float(m["Accuracy"]),
            precision=float(m["Precision"]),
            recall=float(m["Recall"]),
        )

    @torch.no_grad()
    def predict_padded(self, indices, values, embeddings=()) -> torch.Tensor:
        """Logits of padded rows (numpy arrays or tensors), in chunks of
        ``PREDICT_CHUNK`` rows, as a tensor on the device. Scalers are the
        caller's to apply."""
        dev = self.device
        outs = []
        for lo in range(0, max(len(indices), 1), self.PREDICT_CHUNK):
            hi = lo + self.PREDICT_CHUNK
            outs.append(afm_forward(
                self.model_params,
                torch.as_tensor(indices[lo:hi], device=dev).long(),
                torch.as_tensor(values[lo:hi], device=dev),
                [torch.as_tensor(e[lo:hi], device=dev) for e in embeddings],
            ))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def batch_predict(self, rows: list[tuple[list[int], list[float]]], embeddings=None) -> np.ndarray:
        """Logits of sparse rows, each cut to ``num_dimension`` features,
        after the scalers."""
        n = len(rows)
        d = self.num_dimension
        lengths = np.fromiter((min(len(idx), d) for idx, _ in rows), np.int64, n)
        total = int(lengths.sum())
        valid = np.arange(d)[None, :] < lengths[:, None]
        indices = np.zeros((n, d), dtype=np.int32)
        values = np.zeros((n, d), dtype=np.float32)
        indices[valid] = np.fromiter(
            itertools.chain.from_iterable(idx[:d] for idx, _ in rows), np.int32, total)
        values[valid] = np.fromiter(
            itertools.chain.from_iterable(val[:d] for _, val in rows), np.float32, total)
        if self.auto_scale and self.scalers:
            values = apply_scalers(indices, values, self.scalers, valid)
        embs = [np.zeros((n, dim), dtype=np.float32) for dim in self.embedding_dims]
        if embeddings is not None:
            for c in range(len(self.embedding_dims)):
                for i in range(n):
                    if embeddings[i][c] is not None:
                        embs[c][i] = embeddings[i][c]
        return self.predict_padded(indices, values, embs).cpu().numpy()

    # ------------------------------------------------------------- serialize

    def save(self, path: str | Path) -> None:
        """``params.npz`` + ``meta.json``, the reference's files."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez(path / "params.npz", **self.model_params.to_numpy())
        meta = {
            "name": self.name,
            "params": dict(self.params),
            "num_dimension": self.num_dimension,
            "embedding_dims": self.embedding_dims,
            "scalers": {str(k): s.to_dict() for k, s in self.scalers.items()},
            "index": self.index.to_dict() if self.index is not None else None,
        }
        (path / "meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str | Path, device=None) -> "AFM":
        from ..data.unified_index import DirectIndex, UnifiedIndex

        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        model = cls(Params(meta["params"]), device=device)
        model.num_dimension = meta["num_dimension"]
        model.embedding_dims = meta["embedding_dims"]
        model.scalers = {int(k): AutoScaler.from_dict(d) for k, d in meta["scalers"].items()}
        if meta["index"] is not None:
            if "direct" in meta["index"]:
                model.index = DirectIndex.from_dict(meta["index"])
            else:
                model.index = UnifiedIndex.from_dict(meta["index"])
        with np.load(path / "params.npz") as arrays:
            model.model_params = afm_params_from_numpy(dict(arrays), model.device)
        return model
