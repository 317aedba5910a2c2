"""The port's catalog sharding (gorse_tpu_torch/parallel/catalog.py) held
against gorse_tpu's on the CPU: the counterparts of tests/test_catalog.py.

The reference runs on its 8-device CPU mesh (tests/conftest.py), the port on
a CPU ``Mesh`` of as many shards, from the same numpy inputs and key.

Tolerances:
- routing (buffers, owners, ranks, the permutation, what was kept), the
  drop counts and the packed layout: exact;
- gathered rows: exact; scatter-adds ``rtol=1e-5, atol=1e-6``;
- the catalog BPR epoch: the reference's own parity tolerances
  (``rtol=2e-4, atol=1e-6``, the cost ``rtol=1e-4``), against the
  reference's catalog epoch and the port's user-sharded epoch;
- eALS: ``rtol=5e-4, atol=1e-5`` (tests/test_catalog.py's), and 2e-4 of
  each table's largest magnitude against the reference;
- the table-sharded AFM: ``FIT_TOL`` of each table's largest magnitude
  and ``AUC_TOL`` (tests/test_torch_fm.py) against the reference's
  table-sharded fit from its init; under SGD also ``rtol=1e-4, atol=1e-6``
  against the port's dense fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_fm import AUC_TOL, FIT_TOL, _assert_params, flat_of, inject

from gorse_tpu.data import synthetic_cf as ref_synthetic_cf
from gorse_tpu.data.ctr import synthetic_ctr as ref_synthetic_ctr
from gorse_tpu.models import BPR as RefBPR
from gorse_tpu.models import Params as RefParams
from gorse_tpu.models.fm import AFM as RefAFM
from gorse_tpu.models.fm import _afm_train_epoch
from gorse_tpu.models.params import FitConfig as RefFitConfig
from gorse_tpu.parallel import catalog as RC
from gorse_tpu.parallel import make_mesh as ref_make_mesh
from gorse_tpu.parallel import sharded as RS
from gorse_tpu_torch.data.ctr import synthetic_ctr
from gorse_tpu_torch.data.loaders import synthetic_cf
from gorse_tpu_torch.models import ALS, BPR, FitConfig, Params
from gorse_tpu_torch.models.fm import AFM, afm_params_from_numpy, make_optimizer, train_epoch
from gorse_tpu_torch.ops import sampling
from gorse_tpu_torch.parallel import catalog as C
from gorse_tpu_torch.parallel import sharded as S
from gorse_tpu_torch.parallel.mesh import make_mesh


def cpu_mesh(n: int):
    return make_mesh(n, devices=["cpu"])


def rows_of(parts, n=None) -> np.ndarray:
    return torch.cat([t.detach() for t in parts]).numpy()[:n]


def _ref_route(ids, valid, d, cap):
    return [np.asarray(x) for x in jax.jit(RC.route_requests, static_argnums=(2, 3))(
        jnp.asarray(ids), jnp.asarray(valid), d, cap)]


def test_route_requests_places_every_valid_id():
    d, cap, n = 4, 8, 20
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 32, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    got = C.route_requests(torch.as_tensor(ids), torch.as_tensor(valid), d, cap)
    want = _ref_route(ids, valid, d, cap)
    for name, g, w in zip(("buf", "sowner", "srank", "order", "kept", "n_dropped"), got, want):
        assert np.array_equal(g.numpy(), w), name
    buf = got[0].numpy()
    assert int(got[5]) == 0
    placed = sorted(int(v) for dev in range(d) for v in buf[dev] if v >= 0)
    assert all(v % d == dev for dev in range(d) for v in buf[dev] if v >= 0)
    assert placed == sorted(int(i) for i, ok in zip(ids, valid) if ok)


def test_route_requests_overflow_counted():
    d, cap = 2, 4
    ids, valid = np.zeros(16, np.int32), np.ones(16, bool)
    got = C.route_requests(torch.as_tensor(ids), torch.as_tensor(valid), d, cap)
    want = _ref_route(ids, valid, d, cap)
    assert int(got[5]) == int(want[5]) == 16 - cap
    assert np.array_equal(got[0].numpy(), want[0]) and int((got[0] >= 0).sum()) == cap


def test_pack_unpack_catalog_roundtrip():
    rng = np.random.default_rng(1)
    for i_total, d in [(17, 4), (32, 8), (7, 8)]:
        t = rng.normal(size=(i_total, 3)).astype(np.float32)
        packed = C.pack_catalog(t, d)
        assert packed.shape[0] % d == 0
        assert np.array_equal(packed, RC.pack_catalog(t, d))
        np.testing.assert_array_equal(C.unpack_catalog(packed, i_total, d), t)
        np.testing.assert_array_equal(RC.unpack_catalog(packed, i_total, d), t)


def _a2a_case(seed):
    rng = np.random.default_rng(seed)
    i_total, k, n_per, d = 40, 8, 6, 8
    table = rng.normal(size=(i_total, k)).astype(np.float32)
    ids = rng.integers(0, i_total, d * n_per).astype(np.int32)
    valid = rng.random(d * n_per) < 0.9
    deltas = rng.normal(size=(d * n_per, k)).astype(np.float32)
    return table, ids, valid, deltas, RC.request_cap(n_per, d, slack=8.0)


def _run_ref(fn, in_specs, out_specs, *args):
    mesh = ref_make_mesh(8)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))(*args)


def test_a2a_gather_matches_dense_lookup():
    table, ids, valid, _, cap = _a2a_case(2)
    mesh = cpu_mesh(8)
    rows, got, n_drop = C.a2a_gather(mesh, mesh.shard_rows(C.pack_catalog(table, 8)),
                                     mesh.shard_rows(ids), mesh.shard_rows(valid), cap)
    rows, got = rows_of(rows), rows_of(got)
    assert sum(int(x) for x in n_drop) == 0
    assert np.array_equal(got, valid)
    assert np.array_equal(rows[valid], table[ids[valid]]) and not rows[~valid].any()

    axes = ("data", "model")
    rmesh = ref_make_mesh(8)
    r_rows, r_got = _run_ref(
        lambda q, i, v: RC.a2a_gather(q, i, v, axes, 8, cap)[:2],
        (P(axes, None), P(axes), P(axes)), (P(axes, None), P(axes)),
        RS.place_global(rmesh, RC.pack_catalog(table, 8), P(axes, None)),
        RS.place_global(rmesh, ids, P(axes)), RS.place_global(rmesh, valid, P(axes)))
    assert np.array_equal(rows, np.asarray(r_rows)) and np.array_equal(got, np.asarray(r_got))


def test_a2a_scatter_add_matches_dense_scatter():
    table, ids, valid, deltas, cap = _a2a_case(3)
    mesh = cpu_mesh(8)
    out = C.a2a_scatter_add(mesh, mesh.shard_rows(C.pack_catalog(table, 8)),
                            mesh.shard_rows(ids), mesh.shard_rows(valid),
                            mesh.shard_rows(deltas), cap)
    got = C.unpack_catalog(rows_of(out), 40, 8)
    want = table.copy()
    for i, ok, dl in zip(ids, valid, deltas):
        if ok:
            want[i] += dl
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    axes = ("data", "model")
    rmesh = ref_make_mesh(8)
    r_out = _run_ref(
        lambda q, i, v, dl: RC.a2a_scatter_add(q, i, v, dl, axes, 8, cap),
        (P(axes, None), P(axes), P(axes), P(axes, None)), P(axes, None),
        RS.place_global(rmesh, RC.pack_catalog(table, 8), P(axes, None)),
        RS.place_global(rmesh, ids, P(axes)), RS.place_global(rmesh, valid, P(axes)),
        RS.place_global(rmesh, deltas, P(axes, None)))
    np.testing.assert_allclose(got, RC.unpack_catalog(np.asarray(r_out), 40, 8),
                               rtol=1e-5, atol=1e-6)


def _bpr_fixture(seed=0):
    data = ref_synthetic_cf(n_users=96, n_items=40, rank=4, density=0.15, seed=seed)
    train, _ = data.split_cf(seed=0)
    model = RefBPR(RefParams(n_factors=8))
    model.init(train)
    csr = train.padded_user_positives(pad_to=24)
    return (train.count_items(), np.asarray(model.user_factors), np.asarray(model.item_factors),
            csr.padded, csr.counts)


def _port_catalog(d, fixture, n_steps, key, **kw):
    n_items, p0, q0, padded, counts = fixture
    mesh = cpu_mesh(d)
    epoch = C.make_catalog_sharded_bpr_epoch(mesh, n_steps, n_items, 0.05, 0.01, **kw)
    p, q, pp, pc, uids, n_users, _ = C.shard_catalog_bpr_inputs(mesh, p0, q0, padded, counts)
    p, q, stats = epoch(p, q, pp, pc, uids, sampling.prng_key(key))
    return rows_of(p, n_users), C.unpack_catalog(rows_of(q), n_items, d), stats.numpy()


def _ref_catalog(d, fixture, n_steps, key, **kw):
    n_items, p0, q0, padded, counts = fixture
    mesh = ref_make_mesh(d)
    epoch = RC.make_catalog_sharded_bpr_epoch(mesh, n_steps=n_steps, n_items=n_items, lr=0.05,
                                              reg=0.01, **kw)
    p, q, pp, pc, uids, n_users, _ = RC.shard_catalog_bpr_inputs(mesh, p0, q0, padded, counts)
    p, q, stats = epoch(p, q, pp, pc, uids, jax.random.PRNGKey(key))
    return (np.asarray(p)[:n_users], RC.unpack_catalog(np.asarray(q), n_items, d),
            np.asarray(stats))


def test_catalog_bpr_epoch_matches_replicated():
    """The same pairs, so the catalog epoch agrees with the port's
    user-sharded epoch and with the reference's catalog epoch up to the
    order of the sums, with no drops."""
    fixture = _bpr_fixture()
    n_items, p0, q0, padded, counts = fixture
    p2, q2, stats = _port_catalog(8, fixture, 6, 7, slack=16.0)
    assert stats[1] == 0
    mesh = cpu_mesh(8)
    epoch = S.make_sharded_bpr_epoch(mesh, 6, n_items, 0.05, 0.01)
    p, q, pp, pc, uids, n_users = S.shard_bpr_inputs(mesh, p0, q0, padded, counts)
    p1, q1, cost1 = epoch(p, q, pp, pc, uids, sampling.prng_key(7))
    np.testing.assert_allclose(float(cost1), stats[0], rtol=1e-4)
    np.testing.assert_allclose(rows_of(p1, n_users), p2, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(q1[0].numpy(), q2, rtol=2e-4, atol=1e-6)
    rp, rq, rstats = _ref_catalog(8, fixture, 6, 7, slack=16.0)
    assert rstats[1] == stats[1]
    np.testing.assert_allclose(stats[0], rstats[0], rtol=1e-4)
    np.testing.assert_allclose(p2, rp, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(q2, rq, rtol=2e-4, atol=1e-6)


def test_catalog_bpr_epoch_overflow_drops_but_trains():
    """A cap of 1 drops requests: the count is the reference's exactly and
    the factors stay finite and within tolerance of the reference's."""
    fixture = _bpr_fixture(seed=1)
    p, q, stats = _port_catalog(8, fixture, 4, 0, cap=1)
    rp, rq, rstats = _ref_catalog(8, fixture, 4, 0, cap=1)
    assert np.isfinite(stats[0]) and stats[1] > 0
    assert stats[1] == rstats[1]
    assert np.isfinite(p).all() and np.isfinite(q).all()
    np.testing.assert_allclose(p, rp, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(q, rq, rtol=2e-4, atol=1e-6)


def test_catalog_bpr_sharding_invariance():
    """2 and 8 shards agree (the sampler is keyed by global user id; the
    routing is plumbing)."""
    fixture = _bpr_fixture(seed=2)
    two = _port_catalog(2, fixture, 4, 3, slack=16.0)
    eight = _port_catalog(8, fixture, 4, 3, slack=16.0)
    np.testing.assert_allclose(two[0], eight[0], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(two[1], eight[1], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(two[2][0], eight[2][0], rtol=1e-4)
    assert two[2][1] == eight[2][1] == 0


def _share(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_catalog_als_epoch_matches_replicated():
    """Partial Grams psum'd and both tables sharded between half-epochs,
    against the port's replicated-table sharded epoch and the reference's
    catalog epoch."""
    data = ref_synthetic_cf(n_users=64, n_items=48, rank=4, density=0.2, seed=3)
    train, _ = data.split_cf(seed=0)
    model = RefBPR(RefParams(n_factors=8))
    model.init(train)
    p0, q0 = np.asarray(model.user_factors), np.asarray(model.item_factors)
    ufb, ifb = train.padded_user_positives().padded, train.padded_item_positives().padded
    block, alpha, reg = 8, 0.05, 0.015
    mesh = cpu_mesh(8)
    q, *inputs, n_users, n_items = S.shard_als_inputs(mesh, q0, ufb, ifb, block)
    p1, q1 = S.make_sharded_als_epoch(mesh, block, alpha, reg)(q, *inputs)
    p, q, *inputs, _, _ = C.shard_catalog_als_inputs(mesh, p0, q0, ufb, ifb, block)
    p2, q2 = C.make_catalog_sharded_als_epoch(mesh, block, alpha, reg)(p, q, *inputs)
    p2, q2 = rows_of(p2, n_users), rows_of(q2, n_items)
    np.testing.assert_allclose(p1[0][:n_users].numpy(), p2, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(q1[0][:n_items].numpy(), q2, rtol=5e-4, atol=1e-5)

    rmesh = ref_make_mesh(8)
    r_in = RC.shard_catalog_als_inputs(rmesh, p0, q0, ufb, ifb, block)
    rp, rq = RC.make_catalog_sharded_als_epoch(rmesh, block, alpha, reg)(*r_in[:6])
    assert _share(p2, np.asarray(rp)[:n_users]) <= 2e-4
    assert _share(q2, np.asarray(rq)[:n_items]) <= 2e-4


def test_exchange_bytes_and_cap_properties():
    """The cap and the payload are the reference's functions, and keep its
    scaling: linear in the requests, no catalog size in them."""
    for n, d, slack in ((24, 8, 2.0), (20_000, 8, 2.0), (2_000_000, 8, 2.0), (100, 3, 16.0),
                        (5000, 4, 4.0)):
        assert C.request_cap(n, d, slack) == RC.request_cap(n, d, slack)
        for k in (8, 64):
            assert C.exchange_bytes_per_step(n, d, k, slack=slack) == \
                RC.exchange_bytes_per_step(n, d, k, slack=slack)
    k = 64
    b1 = C.exchange_bytes_per_step(2 * 10_000, 8, k)
    b4 = C.exchange_bytes_per_step(8 * 10_000, 8, k)
    assert 3.5 * b1 <= b4 <= 4.5 * b1 and b1 < 1_000_000 * k * 4
    assert C.request_cap(24, 8) == 24
    assert 2 * 1_000_000 / 8 <= C.request_cap(2 * 1_000_000, 8, 2.0) <= 2 * 1_000_000 / 8 * 2.1
    epoch = C.make_catalog_sharded_bpr_epoch(cpu_mesh(8), 1, 10, 0.05, 0.01)
    assert epoch.exchange_bytes_per_step(2 * 10_000, k=k) == b1


def _afm_case(optimizer_hp):
    r_train, r_test = ref_synthetic_ctr(n_samples=512, n_users=32, n_items=24,
                                        seed=0).split(0.25, seed=1)
    train, test = synthetic_ctr(n_samples=512, n_users=32, n_items=24, seed=0).split(0.25, seed=1)
    return r_train, r_test, train, test, optimizer_hp


@pytest.mark.parametrize("hp", [
    dict(n_factors=8, n_epochs=3, batch_size=32, optimizer="sgd", lr=0.05),
    dict(n_factors=8, n_epochs=5, batch_size=32),
], ids=["sgd", "adam"])
def test_sharded_table_afm_matches_the_reference(monkeypatch, hp):
    """The table-sharded AFM fit on 8 shards from the reference's init
    against the reference's table-sharded fit on its 8 devices (no drops
    in either); under SGD also against the port's dense fit, tightly."""
    inject(monkeypatch)
    r_train, r_test, train, test, _ = _afm_case(hp)
    ref = RefAFM(RefParams(hp))
    want = ref.fit(r_train, r_test, RefFitConfig(verbose=0, mesh=ref_make_mesh(8),
                                                 shard_table=True))
    model = AFM(Params(hp), device="cpu")
    got = model.fit(train, test, FitConfig(verbose=0, mesh=cpu_mesh(8), shard_table=True))
    assert int(model.table_drop_count) == int(np.asarray(ref.table_drop_count)) == 0
    _assert_params(model.model_params, ref.model_params, FIT_TOL)
    assert abs(got.auc - want.auc) <= AUC_TOL
    if hp.get("optimizer") == "sgd":
        dense = AFM(Params(hp), device="cpu")
        s_dense = dense.fit(train, test, FitConfig(verbose=0))
        for name in ("v", "w"):
            np.testing.assert_allclose(getattr(model.model_params, name).detach().numpy(),
                                       getattr(dense.model_params, name).detach().numpy(),
                                       rtol=1e-4, atol=1e-6)
        assert abs(s_dense.auc - got.auc) < 5e-3


def test_sharded_table_afm_adam_functional_parity(monkeypatch):
    """Under Adam, against the port's own dense fit: the same AUC and
    accuracy (the reference's gate)."""
    inject(monkeypatch)
    _, _, train, test, hp = _afm_case(dict(n_factors=8, n_epochs=5, batch_size=32))
    s_dense = AFM(Params(hp), device="cpu").fit(train, test, FitConfig(verbose=0))
    model = AFM(Params(hp), device="cpu")
    s_sharded = model.fit(train, test, FitConfig(verbose=0, mesh=cpu_mesh(8), shard_table=True))
    assert int(model.table_drop_count) == 0
    assert abs(s_dense.auc - s_sharded.auc) < 1e-2
    assert abs(s_dense.accuracy - s_sharded.accuracy) < 2e-2


def test_bpr_fit_with_catalog_sharding(monkeypatch):
    """BPR.fit with shard_table from the reference's init against the
    reference's catalog-sharded fit; dense factors back, no drops, the
    user-sharded fit's quality."""
    r_train, r_test = ref_synthetic_cf(n_users=96, n_items=64, rank=4, density=0.15,
                                       seed=4).split_cf(seed=0)
    train, test = synthetic_cf(n_users=96, n_items=64, rank=4, density=0.15,
                               seed=4).split_cf(seed=0)
    params = dict(n_factors=8, n_epochs=20, lr=0.05, reg=0.01)
    ref = RefBPR(RefParams(params))
    r_score = ref.fit(r_train, r_test, RefFitConfig(verbose=0, mesh=ref_make_mesh(8),
                                                    shard_table=True))
    init_model = RefBPR(RefParams(params))
    init_model.init(r_train, seed=0)
    factors = (np.asarray(init_model.user_factors), np.asarray(init_model.item_factors))
    fits = {}
    for shard_table in (True, False):
        model = BPR(Params(params), device="cpu")
        init = model.init
        monkeypatch.setattr(model, "init", lambda tr, seed=0, _i=init: _i(tr, seed, factors=factors))
        fits[shard_table] = (model, model.fit(train, test, FitConfig(
            verbose=0, mesh=cpu_mesh(8), shard_table=shard_table)))
    model, score = fits[True]
    assert model.item_factors.shape == (train.count_items(), 8)
    assert model.user_factors.shape == (train.count_users(), 8)
    assert int(model.catalog_drop_count) == int(np.asarray(ref.catalog_drop_count)) == 0
    np.testing.assert_allclose(model.item_factors.numpy(), np.asarray(ref.item_factors),
                               rtol=2e-4, atol=1e-6)
    assert abs(score.ndcg - r_score.ndcg) <= 1e-3
    assert abs(score.ndcg - fits[False][1].ndcg) < 0.02


def test_als_fit_with_catalog_sharding():
    """ALS.fit with shard_table against the replicated-table sharded fit
    and the reference's catalog-sharded fit (the port's own init for the
    two port fits, the same seed)."""
    kw = dict(n_factors=8, n_epochs=5, reg=0.015, alpha=0.05, solve_block=8)
    train, test = synthetic_cf(n_users=64, n_items=48, rank=4, density=0.2,
                               seed=5).split_cf(seed=0)
    m1 = ALS(Params(kw), device="cpu")
    s1 = m1.fit(train, test, FitConfig(verbose=0, mesh=cpu_mesh(8)))
    m2 = ALS(Params(kw), device="cpu")
    s2 = m2.fit(train, test, FitConfig(verbose=0, mesh=cpu_mesh(8), shard_table=True))
    np.testing.assert_allclose(m1.item_factors.numpy(), m2.item_factors.numpy(),
                               rtol=5e-4, atol=1e-5)
    assert abs(s1.ndcg - s2.ndcg) < 1e-3


def test_sharded_afm_padding_slots_not_routed():
    """Slots of value 0 (the padding of sparse rows) are never requested,
    so a tight cap drops nothing; the table-sharded epoch equals the dense
    epoch (the port's and the reference's) from the same parameters."""
    rng = np.random.default_rng(7)
    n_feat, dmax, batch, s_steps, k = 64, 12, 16, 3, 8
    idx = np.zeros((s_steps, batch, dmax), np.int32)
    val = np.zeros((s_steps, batch, dmax), np.float32)
    for s in range(s_steps):
        for b in range(batch):
            idx[s, b, :3] = rng.choice(n_feat, 3, replace=False)
            val[s, b, :3] = 1.0
    tgt = rng.integers(0, 2, (s_steps, batch)).astype(np.float32)
    wgt = np.ones((s_steps, batch), np.float32)

    ref = RefAFM(RefParams(n_factors=k, optimizer="sgd", lr=0.05))
    tree = ref._init_params(n_feat, [], 0)
    tx = ref._make_optimizer()
    r_params, _, r_cost = _afm_train_epoch(jax.tree.map(jnp.array, tree), tx.init(tree),
                                           jnp.asarray(idx), jnp.asarray(val), jnp.asarray(tgt),
                                           jnp.asarray(wgt), (), optimizer=tx)
    flat = flat_of(tree)
    batches = (torch.as_tensor(idx).long(), torch.as_tensor(val), torch.as_tensor(tgt),
               torch.as_tensor(wgt), ())

    dense = afm_params_from_numpy(flat, "cpu")
    c_dense = train_epoch(dense, make_optimizer("sgd", dense.parameters(), 0.05, 0.0002),
                          batches)
    mesh = cpu_mesh(8)
    sharded = C.shard_afm_params(mesh, afm_params_from_numpy(flat, "cpu"))
    opt = make_optimizer("sgd", sharded.leaves(), 0.05, 0.0002)
    c_shard, dropped = C.make_sharded_afm_epoch(mesh)(sharded, opt,
                                                      *S.shard_afm_batches(mesh, batches))
    assert int(dropped) == 0
    got = C.unshard_afm_params(mesh, sharded, n_feat, k)
    np.testing.assert_allclose(float(c_dense), float(c_shard), rtol=1e-5)
    np.testing.assert_allclose(float(r_cost), float(c_shard), rtol=1e-5)
    for name in ("v", "w"):
        for want in (getattr(dense, name).detach().numpy(), np.asarray(r_params[name])):
            np.testing.assert_allclose(getattr(got, name).detach().numpy(), want,
                                       rtol=1e-4, atol=1e-6)
