"""The port's sharded training and retrieval (gorse_tpu_torch/parallel/
sharded.py, the trainers' mesh branches) held against gorse_tpu's on the CPU:
the counterparts of tests/test_sharded.py.

The reference runs on its 8-device CPU mesh (tests/conftest.py), the port on
a CPU ``Mesh`` of as many shards (``make_mesh(n, devices=["cpu"])``), from
the same numpy inputs, the same key and, for fits, the reference's init.
The BPR fit on a mesh is held in tests/test_torch_bpr.py
(``test_fit_matches_the_reference_sharded_fit``), from the seed.

Tolerances:
- sampled pairs, top-k ids and their tie order: exact (the same counter
  sampler over global user ids, the sharded epochs' draw in both packages;
  bf16-exact integer scores);
- BPR epochs and fits: ``rtol=1e-4, atol=1e-6`` (the dot products and the
  item sums run in another order: ``sum(p*qi) - sum(p*qj)`` in the sweep,
  ``sum(p*(qi - qj))`` in the reference's XLA epoch), the cost ``rtol=1e-5``;
- eALS: 2e-4 of each table's largest magnitude (tests/test_torch_als.py:
  the same systems, summed and factored in another order);
- the AFM: tests/test_torch_fm.py's ``FIT_TOL`` of each table's largest
  magnitude and ``AUC_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fm import AUC_TOL, FIT_TOL, _assert_params, inject

from gorse_tpu.data import synthetic_cf as ref_synthetic_cf
from gorse_tpu.data.ctr import synthetic_ctr as ref_synthetic_ctr
from gorse_tpu.data.loaders import synthetic_cf_access as ref_synthetic_cf_access
from gorse_tpu.models import ALS as RefALS
from gorse_tpu.models import BPR as RefBPR
from gorse_tpu.models import FitConfig as RefFitConfig
from gorse_tpu.models import Params as RefParams
from gorse_tpu.models.fm import AFM as RefAFM
from gorse_tpu.ops.bpr_kernel import pack_items, unpack_items
from gorse_tpu.parallel import make_mesh as ref_make_mesh
from gorse_tpu.parallel import sharded as RS
from gorse_tpu_torch.data.ctr import synthetic_ctr
from gorse_tpu_torch.data.loaders import synthetic_cf, synthetic_cf_access
from gorse_tpu_torch.models import ALS, BPR, FitConfig, Params
from gorse_tpu_torch.models.als import _als_solve_rows, padded_blocks
from gorse_tpu_torch.models.fm import AFM
from gorse_tpu_torch.ops import bpr_kernel as bk
from gorse_tpu_torch.ops import sampling
from gorse_tpu_torch.parallel import sharded as S
from gorse_tpu_torch.parallel.mesh import make_mesh

LR, REG = 0.05, 0.01


def cpu_mesh(n: int):
    return make_mesh(n, devices=["cpu"])


def rows_of(parts, n=None) -> np.ndarray:
    """A row-sharded value's local shards as one array, cut to n rows."""
    return torch.cat([t.detach() for t in parts]).numpy()[:n]


@pytest.fixture(scope="module")
def setup():
    data = ref_synthetic_cf(n_users=93, n_items=70, rank=4, density=0.15, seed=3)
    train, _ = data.split_cf(seed=0)
    csr = train.padded_user_positives()
    rng = np.random.default_rng(0)
    p0 = rng.normal(scale=0.01, size=(train.count_users(), 8)).astype(np.float32)
    q0 = rng.normal(scale=0.01, size=(train.count_items(), 8)).astype(np.float32)
    return train.count_items(), csr.padded, csr.counts, p0, q0


def _ref_epoch(mesh, setup, n_steps, key, sync_every=1):
    n_items, padded, counts, p0, q0 = setup
    epoch = RS.make_sharded_bpr_epoch(mesh, n_steps=n_steps, n_items=n_items, lr=LR, reg=REG,
                                      sync_every=sync_every)
    p, q, pp, pc, uids, n_users = RS.shard_bpr_inputs(mesh, p0, q0, padded, counts)
    p, q, cost = epoch(p, q, pp, pc, uids, jax.random.PRNGKey(key))
    return np.asarray(p)[:n_users], np.asarray(q), float(cost[0])


def _port_epoch(n_shards, setup, n_steps, key, sync_every=1, pairs=False,
                sweep=bk.bpr_sweep_pairs):
    n_items, padded, counts, p0, q0 = setup
    mesh = cpu_mesh(n_shards)
    epoch = S.make_sharded_bpr_epoch(mesh, n_steps, n_items, LR, REG, sync_every=sync_every,
                                     sweep=sweep)
    p, q, pp, pc, uids, n_users = S.shard_bpr_inputs(mesh, p0, q0, padded, counts)
    got = [torch.zeros((2, n_steps, t.shape[0]), dtype=torch.int32) for t in p] if pairs else None
    p, q, cost = epoch(p, q, pp, pc, uids, sampling.prng_key(key), pairs=got)
    out = rows_of(p, n_users), q[0].numpy(), float(cost)
    if pairs:
        out += (torch.cat(got, dim=2)[:, :, :n_users],)
    return out


def test_sharded_epoch_matches_single_device(setup):
    """8 shards against the reference's 8-device epoch and the port's
    user-sharded epoch on one shard (the counter sampler on one device; the
    single-device fit draws the reference's one-device sampler instead):
    the same pairs every step, the same factors up to summation order."""
    p8, q8, c8, pairs8 = _port_epoch(8, setup, 5, 7, pairs=True)
    rp, rq, rc = _ref_epoch(ref_make_mesh(8), setup, 5, 7)
    np.testing.assert_allclose(p8, rp, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(q8, rq, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(c8, rc, rtol=1e-5)

    p1, q1, c1, pairs1 = _port_epoch(1, setup, 5, 7, pairs=True)
    assert torch.equal(pairs8, pairs1)
    np.testing.assert_allclose(p8, p1, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(q8, q1, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(c8, c1, rtol=1e-5)


def test_sharded_epoch_learns(setup):
    """15 epochs of 20 steps on 8 shards: the loss falls as the
    reference's does, epoch by epoch within the cost tolerance."""
    n_items, padded, counts, p0, q0 = setup
    mesh, rmesh = cpu_mesh(8), ref_make_mesh(8)
    epoch = S.make_sharded_bpr_epoch(mesh, 20, n_items, LR, REG)
    ref_epoch = RS.make_sharded_bpr_epoch(rmesh, n_steps=20, n_items=n_items, lr=LR, reg=REG)
    p, q, pp, pc, uids, _ = S.shard_bpr_inputs(mesh, p0, q0, padded, counts)
    rp, rq, rpp, rpc, ruids, _ = RS.shard_bpr_inputs(rmesh, p0, q0, padded, counts)
    key, rkey = sampling.prng_key(0), jax.random.PRNGKey(0)
    costs, ref_costs = [], []
    for _ in range(15):
        key, ke = sampling.split(key)
        rkey, rke = jax.random.split(rkey)
        p, q, cost = epoch(p, q, pp, pc, uids, ke)
        rp, rq, rcost = ref_epoch(rp, rq, rpp, rpc, ruids, rke)
        costs.append(float(cost))
        ref_costs.append(float(rcost[0]))
    assert costs[-1] < costs[0] - 1.0, costs
    np.testing.assert_allclose(costs, ref_costs, rtol=1e-4)


@pytest.mark.parametrize("n_shards", [8, 3])
def test_sharded_topk_matches_dense(n_shards):
    """Item-sharded top-k with forced ties (small integer factors, exact in
    bf16 and f32): ids, their tie order and scores equal the reference's
    sharded top-k and the port's ``dot_topk`` over the whole table."""
    from gorse_tpu_torch.ops.topk import dot_topk

    rng = np.random.default_rng(1)
    queries = rng.integers(-2, 3, size=(6, 16)).astype(np.float32)
    items = rng.integers(-2, 3, size=(n_shards * 13, 16)).astype(np.float32)
    items[5] = items[17] = items[38]  # duplicate rows across shards
    mesh = cpu_mesh(n_shards)
    s, i = S.make_sharded_topk(mesh, 7)(queries, S.shard_items(mesh, items))
    rs, ri = RS.make_sharded_topk(ref_make_mesh(n_shards), k_top=7)(jnp.asarray(queries),
                                                                    jnp.asarray(items))
    assert np.array_equal(i.numpy(), np.asarray(ri))
    assert np.array_equal(s.numpy(), np.asarray(rs))
    ds, di = dot_topk(queries, items, 7, device="cpu")
    assert torch.equal(i, di) and torch.equal(s, ds)
    scores = queries @ items.T
    assert len(np.unique(scores)) < scores.size // 4  # ties are many


def _fused_setup(seed):
    n_users, n_items, k = 96, 64, 16
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 12, size=n_users).astype(np.int32)
    padded = np.full((n_users, 16), -1, dtype=np.int32)
    for u in range(n_users):
        padded[u, : counts[u]] = rng.choice(n_items, size=counts[u], replace=False)
    p0 = rng.normal(scale=0.01, size=(n_users, k)).astype(np.float32)
    q0 = rng.normal(scale=0.01, size=(n_items, k)).astype(np.float32)
    return n_items, padded, counts, p0, q0


def _ref_fused(setup, n_steps, key, sync_every):
    n_items, padded, counts, p0, q0 = setup
    mesh = ref_make_mesh(4)
    p, _, pp, pc, uids, _ = RS.shard_bpr_inputs(mesh, p0, q0, padded, counts)
    qp = jax.device_put(pack_items(jnp.asarray(q0)),
                        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    epoch = RS.make_sharded_bpr_epoch_fused(mesh, n_steps=n_steps, n_items=n_items, lr=LR,
                                            reg=REG, interpret=True, sync_every=sync_every)
    p, qp, cost = epoch(p, qp, pp, pc, uids, jax.random.PRNGKey(key))
    return np.asarray(p), np.asarray(unpack_items(qp, n_items, q0.shape[1])), float(cost[0])


def test_sharded_fused_kernel_matches_xla_path():
    """The sharded epoch through K3 (its plain version here) on 4 shards
    against the reference's fused sharded epoch (the Pallas kernel in
    interpret mode) and its XLA sharded epoch."""
    setup = _fused_setup(3)
    p, q, cost = _port_epoch(4, setup, 5, 7)
    fp, fq, fc = _ref_fused(setup, 5, 7, 1)
    xp, xq, xc = _ref_epoch(ref_make_mesh(4), setup, 5, 7)
    for want_p, want_q, want_c in ((fp, fq, fc), (xp, xq, xc)):
        np.testing.assert_allclose(p, want_p, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(q, want_q, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(cost, want_c, rtol=1e-5)


def _als_setup():
    data = ref_synthetic_cf(n_users=57, n_items=41, rank=4, density=0.2, seed=5)
    train, _ = data.split_cf(seed=0)
    rng = np.random.default_rng(2)
    q0 = rng.normal(scale=0.1, size=(train.count_items(), 8)).astype(np.float32)
    return train, q0


def _share(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_sharded_als_epoch_matches_single_device():
    """The sharded eALS epoch on 8 shards against the reference's on 8
    devices and the port's single-device half-epochs."""
    train, q0 = _als_setup()
    n_users, n_items = train.count_users(), train.count_items()
    user_fb = train.padded_user_positives().padded
    item_fb = train.padded_item_positives().padded
    block, alpha, reg = 8, 0.05, 0.015

    rmesh = ref_make_mesh(8)
    r_in = RS.shard_als_inputs(rmesh, q0, user_fb, item_fb, block)
    rp, rq = RS.make_sharded_als_epoch(rmesh, block, alpha, reg)(*r_in[:5])

    mesh = cpu_mesh(8)
    q, ufb, ifb, umask, imask, nu, ni = S.shard_als_inputs(mesh, q0, user_fb, item_fb, block)
    assert (nu, ni) == (n_users, n_items) and q[0].shape[0] % (8 * block) == 0
    p, q = S.make_sharded_als_epoch(mesh, block, alpha, reg)(q, ufb, ifb, umask, imask)
    assert _share(p[0][:n_users], np.asarray(rp)[:n_users]) <= 2e-4
    assert _share(q[0][:n_items], np.asarray(rq)[:n_items]) <= 2e-4
    assert not p[0][n_users:].any() and not q[0][n_items:].any()  # padding rows solve to 0

    ufl, ifl = train.user_feedback, train.item_feedback
    imask1 = torch.tensor([float(len(r) > 0) for r in ifl])
    umask1 = torch.tensor([float(len(r) > 0) for r in ufl])
    p1 = _als_solve_rows(torch.as_tensor(q0), padded_blocks(ufl, block, "cpu"), alpha, reg,
                         other_mask=imask1)[:n_users]
    q1 = _als_solve_rows(p1, padded_blocks(ifl, block, "cpu"), alpha, reg,
                         other_mask=umask1)[:n_items]
    assert _share(p[0][:n_users], p1) <= 2e-4 and _share(q[0][:n_items], q1) <= 2e-4


def _mf_fit(model_cls, ref_cls, params, data_args, mesh_n, monkeypatch, **cfg):
    r_train, r_test = ref_synthetic_cf(**data_args).split_cf(seed=0)
    train, test = synthetic_cf(**data_args).split_cf(seed=0)
    ref = ref_cls(RefParams(params))
    r_score = ref.fit(r_train, r_test, RefFitConfig(verbose=0, mesh=ref_make_mesh(mesh_n), **cfg))
    init_model = ref_cls(RefParams(params))
    init_model.init(r_train, seed=0)
    factors = (np.asarray(init_model.user_factors), np.asarray(init_model.item_factors))
    model = model_cls(Params(params), device="cpu")
    init = model.init
    monkeypatch.setattr(model, "init", lambda tr, seed=0: init(tr, seed, factors=factors))
    score = model.fit(train, test, FitConfig(verbose=0, mesh=cpu_mesh(mesh_n), **cfg))
    return ref, r_score, model, score, factors


def test_als_fit_with_mesh(monkeypatch):
    """ALS.fit on an 8-shard mesh from the reference's init against the
    reference's fit on its 8-device mesh; NDCG as the single-device fit's."""
    params = dict(n_factors=8, n_epochs=8, reg=0.015, alpha=0.05)
    data = dict(n_users=120, n_items=60, rank=4, density=0.25, seed=1)
    ref, r_score, model, score, factors = _mf_fit(ALS, RefALS, params, data, 8, monkeypatch)
    assert model.item_factors.shape == (60, 8) and model.user_factors.shape[1] == 8
    assert _share(model.user_factors, ref.user_factors) <= 2e-4
    assert _share(model.item_factors, ref.item_factors) <= 2e-4
    assert abs(score.ndcg - r_score.ndcg) <= 1e-3 and score.ndcg > 0.5
    train, test = synthetic_cf(**data).split_cf(seed=0)
    single = ALS(Params(params), device="cpu")
    init = single.init
    monkeypatch.setattr(single, "init", lambda tr, seed=0: init(tr, seed, factors=factors))
    assert abs(score.ndcg - single.fit(train, test, FitConfig(verbose=0)).ndcg) <= 1e-3


@pytest.mark.parametrize("shard_table", [False, True])
def test_als_fit_with_mesh_no_epoch(shard_table):
    """With no epoch to run, a fit on a mesh keeps the init factors, as the
    single-device fit does, in both sharded layouts."""
    train, test = synthetic_cf(n_users=30, n_items=20, rank=4, density=0.3,
                               seed=1).split_cf(seed=0)
    kw = dict(n_factors=8, n_epochs=0, solve_block=8)
    single = ALS(Params(kw), device="cpu")
    single.fit(train, test, FitConfig(verbose=0))
    model = ALS(Params(kw), device="cpu")
    model.fit(train, test, FitConfig(verbose=0, mesh=cpu_mesh(8), shard_table=shard_table))
    assert torch.equal(model.user_factors, single.user_factors)
    assert torch.equal(model.item_factors, single.item_factors)


@pytest.mark.parametrize("n_shards,batch", [(8, 64), (3, 1024)])
def test_afm_fit_with_mesh_matches_single_device(monkeypatch, n_shards, batch):
    """The data-parallel AFM on n shards against the reference's on n
    devices from its init; on 3 shards the batch rounds 1024 -> 1026, as the
    reference's does (the rounded batch changes the steps, so it must be
    the reference's)."""
    inject(monkeypatch)
    hp = dict(n_factors=8, n_epochs=3, lr=0.01, batch_size=batch)
    r_train, r_test = ref_synthetic_ctr(n_samples=1400, n_users=40, n_items=30,
                                        seed=0).split(0.2, seed=1)
    train, test = synthetic_ctr(n_samples=1400, n_users=40, n_items=30, seed=0).split(0.2, seed=1)
    ref = RefAFM(RefParams(hp))
    want = ref.fit(r_train, r_test, RefFitConfig(verbose=0, mesh=ref_make_mesh(n_shards)))
    model = AFM(Params(hp), device="cpu")
    seen = []
    batch_of = model._batch
    monkeypatch.setattr(model, "_batch", lambda pad, b: seen.append(b) or batch_of(pad, b))
    got = model.fit(train, test, FitConfig(verbose=0, mesh=cpu_mesh(n_shards)))
    assert seen == [-(-batch // n_shards) * n_shards]
    _assert_params(model.model_params, ref.model_params, FIT_TOL)
    assert abs(got.auc - want.auc) <= AUC_TOL


@pytest.mark.parametrize("steps_a_chunk", [None, 3])
def test_sample_pairs_matches_each_step(setup, monkeypatch, steps_a_chunk):
    """An epoch's pairs drawn at once, in one chunk or three steps a chunk,
    are each step's ``sample_pair`` bit for bit."""
    n_items, padded, counts, _, _ = setup
    pp, pc = torch.as_tensor(padded), torch.as_tensor(counts)
    uids = torch.arange(pp.shape[0], dtype=torch.int32) + 40
    if steps_a_chunk:
        monkeypatch.setattr(sampling, "_COMPARE_ELEMENTS", steps_a_chunk * pp.numel() * 3)
    keys = sampling.raw_step_keys(sampling.prng_key(5), 7)
    pos, neg = sampling.sample_pairs(pp, pc, uids, keys, n_items, 3)
    assert pos.shape == neg.shape == (7, pp.shape[0])
    for s, kd in enumerate(keys):
        want = sampling.sample_pair(pp, pc, uids, kd, n_items, 3)
        assert torch.equal(pos[s], want[0]) and torch.equal(neg[s], want[1])
    ref = RS._sample_pair(jnp.asarray(padded), jnp.asarray(counts), jnp.asarray(uids.numpy()),
                          jnp.array(keys[6], dtype=jnp.uint32), n_items, 3)
    assert np.array_equal(pos[6].numpy(), np.asarray(ref[0]))
    assert np.array_equal(neg[6].numpy(), np.asarray(ref[1]))


def test_per_user_uniforms_slice_invariant():
    """Any slice of the user axis, contiguous or not, gives the rows of the
    full draw bit for bit, and the reference's."""
    kd = (123, 987654321)
    full = sampling.per_user_uniforms(kd, torch.arange(256), 5)
    assert torch.equal(full[64:192], sampling.per_user_uniforms(kd, torch.arange(64, 192), 5))
    picked = torch.tensor([3, 17, 99, 200])
    assert torch.equal(full[picked], sampling.per_user_uniforms(kd, picked, 5))
    ref = RS._per_user_uniforms(jnp.array(kd, dtype=jnp.uint32), jnp.arange(256, dtype=jnp.int32), 5)
    assert np.array_equal(full.numpy(), np.asarray(ref))
    big = sampling.per_user_uniforms(kd, torch.arange(20000), 4)
    assert 0.49 < float(big.mean()) < 0.51 and float(big.std()) > 0.27
    assert float(big.min()) >= 0.0 and float(big.max()) < 1.0


def test_threefry_matches_jax_reference():
    """The counter cipher is jax.random's threefry-2x32, word for word."""
    from jax._src.prng import threefry_2x32

    k0, k1 = 0xDEADBEEF, 0x12345678
    x0 = (np.arange(33, dtype=np.uint64) * 2654435761) % 2**32
    x1 = np.arange(33, dtype=np.uint64) * 97
    w0, w1 = sampling.threefry2x32(k0, k1, torch.as_tensor(x0.astype(np.int64)),
                                   torch.as_tensor(x1.astype(np.int64)))
    ref = np.asarray(threefry_2x32(jnp.array([k0, k1], dtype=jnp.uint32),
                                   jnp.asarray(np.concatenate([x0, x1]).astype(np.uint32))))
    assert np.array_equal(ref, np.concatenate([w0.numpy(), w1.numpy()]).astype(np.uint32))


@pytest.mark.parametrize("sync_every", [2, 4])
def test_sync_every_variant(setup, sync_every):
    """sync_every > 1 on 4 shards: deterministic, learns, and the
    reference's variant (its own accumulators a shard) epoch for epoch."""
    n_items, padded, counts, p0, q0 = setup
    mesh, rmesh = cpu_mesh(4), ref_make_mesh(4)

    def run(n):
        epoch = S.make_sharded_bpr_epoch(mesh, 20, n_items, LR, REG, sync_every=sync_every)
        p, q, pp, pc, uids, n_users = S.shard_bpr_inputs(mesh, p0, q0, padded, counts)
        key, costs = sampling.prng_key(0), []
        for _ in range(n):
            key, ke = sampling.split(key)
            p, q, cost = epoch(p, q, pp, pc, uids, ke)
            costs.append(float(cost))
        return rows_of(p, n_users), q[0].numpy(), costs

    p_a, q_a, costs_a = run(10)
    p_b, q_b, costs_b = run(10)
    assert np.array_equal(p_a, p_b) and np.array_equal(q_a, q_b)
    assert costs_a[-1] < costs_a[0] - 1.0, costs_a
    _, ke = sampling.split(sampling.prng_key(0))
    ep = S.make_sharded_bpr_epoch(mesh, 20, n_items, LR, REG, sync_every=sync_every)
    p, q, pp, pc, uids, n_users = S.shard_bpr_inputs(mesh, p0, q0, padded, counts)
    rk = jax.random.split(jax.random.PRNGKey(0))[1]
    rp, rq, rc = (np.asarray(x) for x in RS.make_sharded_bpr_epoch(
        rmesh, n_steps=20, n_items=n_items, lr=LR, reg=REG, sync_every=sync_every)(
        *RS.shard_bpr_inputs(rmesh, p0, q0, padded, counts)[:5], rk))
    p, q, cost = ep(p, q, pp, pc, uids, ke)
    np.testing.assert_allclose(rows_of(p, n_users), rp[:n_users], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(q[0].numpy(), rq, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(cost), float(rc[0]), rtol=1e-5)
    assert not np.array_equal(q[0].numpy(), _port_epoch(4, setup, 20, 0)[1])  # not sync_every 1


@pytest.mark.parametrize("sync_every", [2, 3])
def test_sync_every_fused_matches_xla_variant(sync_every):
    """The sharded epoch's sync_every > 1 through K3 (its plain version)
    against the reference's fused variant (interpret mode) and its XLA
    variant, 6 steps on 4 shards."""
    setup = _fused_setup(4)
    p, q, cost = _port_epoch(4, setup, 6, 11, sync_every)
    for want in (_ref_fused(setup, 6, 11, sync_every),
                 _ref_epoch(ref_make_mesh(4), setup, 6, 11, sync_every)):
        np.testing.assert_allclose(p, want[0], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(q, want[1], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(cost, want[2], rtol=1e-5)


def test_sync_every_accuracy_regression():
    """The staleness gate on a Zipf corpus at the port's test size (600 x
    800, 30,000 rows; 4 shards): sync 4 within 0.03 and sync 16 within
    0.10 of the exact epoch's NDCG, each within 1e-3 of the reference's
    fit with the same sync on its 4-device mesh from the same init."""
    data, ref_data = (f(600, 800, nnz=30_000, seed=5) for f in (synthetic_cf_access,
                                                              ref_synthetic_cf_access))
    train, test = data.split_cf(seed=0)
    r_train, r_test = ref_data.split_cf(seed=0)
    init_model = RefBPR(RefParams(n_factors=8))
    init_model.init(r_train, seed=0)
    factors = (np.asarray(init_model.user_factors), np.asarray(init_model.item_factors))
    scores = {}
    for sync in (1, 4, 16):
        params = dict(n_factors=8, n_epochs=8, lr=0.05, reg=0.01)
        model = BPR(Params(params), device="cpu")
        init = model.init
        model.init = lambda tr, seed=0, _init=init: _init(tr, seed, factors=factors)
        scores[sync] = model.fit(train, test, FitConfig(verbose=0, mesh=cpu_mesh(4),
                                                        sync_every=sync)).ndcg
        ref = RefBPR(RefParams(params)).fit(r_train, r_test, RefFitConfig(
            verbose=0, mesh=ref_make_mesh(4), sync_every=sync))
        assert abs(scores[sync] - ref.ndcg) <= 1e-3, (sync, scores[sync], ref.ndcg)
    assert scores[4] >= scores[1] - 0.03, scores
    assert scores[16] >= scores[1] - 0.10, scores
