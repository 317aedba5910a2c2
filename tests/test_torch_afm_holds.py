"""chip_smoke.py's AFM holds (``afm_holds``: Adam in lockstep, the epoch under
SGD) on the CPU, at a small size.

Two fits that differ only in summation order (the data-parallel epoch on 4
CPU shards against one CPU) pass every hold; each hold fails on each fault
planted in the side under test that it can see:
- one shard's loss divided by its own weight sum instead of the psum'd one;
- one shard's gradients left out of ``summed_grads``;
- Adam's b2 = 0.99 (the lockstep only: the SGD epoch runs no Adam).
The same holds pass and catch the Adam fault between two single-device
sides set up as phase 9's stage_afm epoch (``test`` None). The hold of two
free-running Adam epochs (``hold_adam_epoch``: entries past ``AFM_TOL``
within one row's) passes the reordered pair, allows one row's entries
and fails on each of the three faults. Logits of
exactly zero (an all-zero init) pass the lockstep with the reference's
slope there and fail it with the old ``clamp`` form's.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gorse_tpu_torch.data.ctr import synthetic_ctr
from gorse_tpu_torch.models import fm
from gorse_tpu_torch.parallel import sharded
from gorse_tpu_torch.parallel.mesh import make_mesh

HP = {"n_factors": 4, "batch_size": 256}


@pytest.fixture(scope="module")
def rows():
    return synthetic_ctr(n_samples=4000, seed=3).split(0.2, seed=0)


def _sides(rows, sharded_a: bool):
    train, test = rows
    if sharded_a:
        mesh = make_mesh(4, devices=[torch.device("cpu")])
        return (cs.AfmSide("cpu", mesh, HP, train, test),
                cs.AfmSide("cpu", None, HP, train, test))
    return cs.AfmSide("cpu", None, HP, train, None), cs.AfmSide("cpu", None, HP, train, None)


def _own_weight_sum(mesh):
    """make_data_parallel_afm_gradients with shard 0's loss divided by its
    own weight sum."""
    from gorse_tpu_torch.models.fm import afm_forward, bce_terms

    def gradients(params, replicas, bi, bv, bt, bw, be, step):
        replicas.refresh()
        leaves = list(params.parameters())
        den = mesh.psum([w[step].sum() for w in bw])
        den[0] = bw[0][step].sum()
        grads, parts = [], []
        for j in range(mesh.local_size):
            model = replicas[j]
            logits = afm_forward(model, bi[j][step], bv[j][step], [e[j][step] for e in be])
            loss = (bce_terms(logits, bt[j][step]) * bw[j][step]).sum() / den[j].clamp(min=1.0)
            grads.append(torch.autograd.grad(loss, list(model.parameters()), allow_unused=True))
            parts.append(loss.detach())
        for p, g in zip(leaves, sharded.summed_grads(mesh, grads, leaves)):
            p.grad = g
        return mesh.psum(parts)[0]

    return gradients


def _drop_last_shard(summed):
    def summed_grads(mesh, grads, params):
        grads = list(grads)
        grads[-1] = [None if g is None else torch.zeros_like(g) for g in grads[-1]]
        return summed(mesh, grads, params)

    return summed_grads


def _adam_b2(side):
    make = side.optimizer

    def optimizer(name, params):
        if name != "adam":
            return make(name, params)
        return fm.OptaxAdam(params.parameters(), side.model.lr, side.model.reg, b2=0.99)

    side.optimizer = optimizer


def _plant(monkeypatch, fault, side):
    if fault == "own_weight_sum":
        monkeypatch.setattr(sharded, "make_data_parallel_afm_gradients", _own_weight_sum)
    elif fault == "drop_shard":
        monkeypatch.setattr(sharded, "summed_grads", _drop_last_shard(sharded.summed_grads))
    else:
        _adam_b2(side)


def test_sharded_and_single_pass_every_hold(rows):
    a, b = _sides(rows, sharded_a=True)
    lock = cs.hold_afm_lockstep(a, b, "4 shards against one")
    assert lock["steps"] == a.n_steps == 13
    assert all(x <= 1.0 for r in lock["worst_ratio"].values() for x in r.values())
    # the gradients differ by rounding, well inside their bound
    assert 0 < max(r["grad"] for r in lock["worst_ratio"].values()) < 0.2
    sgd = cs.hold_afm_sgd(a, b, "4 shards against one")
    assert max(sgd.values()) <= cs.AFM_TOL
    assert set(cs.afm_holds("x", a, b)) == {"lockstep", "sgd_shares"}


def test_holds_over_a_prefix_of_steps(rows):
    """``afm_holds`` over the first steps only (phase 9's master pair):
    the lockstep's steps and an SGD epoch cut to them, both sides."""
    for sharded_a in (True, False):
        a, b = _sides(rows, sharded_a)
        got = cs.afm_holds("prefix", a, b, 5)
        assert got["lockstep"]["steps"] == 5
        pa, pb = a.fresh(), b.fresh()
        a.epoch(pa, a.optimizer("sgd", pa), 5)
        b.epoch(pb, b.optimizer("sgd", pb))
        assert not torch.equal(pa.v, pb.v)  # five steps are not thirteen


def test_stage_sides_pass_every_hold(rows):
    a, b = _sides(rows, sharded_a=False)
    lock = cs.hold_afm_lockstep(a, b, "stage")
    assert lock["flips"] == 0 and lock["largest_update_gap_over_lr"] == 0.0
    assert cs.hold_afm_sgd(a, b, "stage") == {"b": 0.0, "v": 0.0, "w": 0.0}


@pytest.mark.parametrize("fault", ["own_weight_sum", "drop_shard", "adam_b2"])
def test_lockstep_fails_on_each_fault(monkeypatch, rows, fault):
    a, b = _sides(rows, sharded_a=True)
    _plant(monkeypatch, fault, a)
    with pytest.raises(RuntimeError, match="Adam in lockstep"):
        cs.hold_afm_lockstep(a, b, "4 shards against one")


@pytest.mark.parametrize("fault", ["own_weight_sum", "drop_shard"])
def test_sgd_epoch_fails_on_each_gradient_fault(monkeypatch, rows, fault):
    a, b = _sides(rows, sharded_a=True)
    _plant(monkeypatch, fault, a)
    with pytest.raises(RuntimeError, match="SGD epoch"):
        cs.hold_afm_sgd(a, b, "4 shards against one")


@pytest.mark.parametrize("fault", ["own_weight_sum", "drop_shard", "adam_b2"])
def test_afm_holds_fail_on_each_fault(monkeypatch, rows, fault):
    """The three comparisons' restated hold (``afm_holds``) on the sharded
    pair, each fault planted."""
    if fault == "adam_b2":
        monkeypatch.setattr(cs.AfmSide, "optimizer", _b2_on_meshes(cs.AfmSide.optimizer))
    else:
        _plant(monkeypatch, fault, None)
    a, b = _sides(rows, sharded_a=True)
    with pytest.raises(RuntimeError, match="check failed"):
        cs.afm_holds("x", a, b)


def _b2_on_meshes(make):
    """AfmSide.optimizer with b2 = 0.99 on the side that has a mesh."""
    def optimizer(self, name, params):
        if name != "adam" or self.mesh is None:
            return make(self, name, params)
        return fm.OptaxAdam(params.parameters(), self.model.lr, self.model.reg, b2=0.99)

    return optimizer


def _clamp_bce(logits, targets):
    """The loss before the reference's slope at zero: ``clamp``'s slope of
    1 at its bound."""
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def test_lockstep_holds_zero_logits_to_the_references_slope(monkeypatch, rows):
    a, b = _sides(rows, sharded_a=True)
    for side in (a, b):
        side.init = {k: np.zeros_like(v) for k, v in side.init.items()}
    cs.hold_afm_lockstep(a, b, "zero logits")
    monkeypatch.setattr(fm, "bce_terms", _clamp_bce)
    with pytest.raises(RuntimeError, match="step 0, side a's w gradient"):
        cs.hold_afm_lockstep(a, b, "zero logits")


def test_stage_lockstep_fails_on_adam_b2(rows):
    a, b = _sides(rows, sharded_a=False)
    _adam_b2(a)
    with pytest.raises(RuntimeError, match="nu at"):
        cs.hold_afm_lockstep(a, b, "stage")


def test_grad_bound_covers_a_reordered_sum(rows):
    """``afm_grad_bound`` against the same step's gradients summed in two
    orders (the batch's rows forward and reversed); the worst-case bound
    stays under 2% of the table's largest gradient (``b`` sums 256 rows'
    slopes of either sign: its bound is 0.4% of it here), so a shard's
    share of a gradient (a quarter) cannot pass it."""
    side = _sides(rows, sharded_a=False)[1]
    params = side.fresh()
    p0 = {n: t.detach().double() for n, t in params.named_parameters()}
    batch = tuple(x[0] for x in side.batches[:4])
    exact, bound = cs.afm_grad_bound(p0, batch)
    got = []
    n_rows = batch[0].shape[0]
    for order in (torch.arange(n_rows), torch.arange(n_rows - 1, -1, -1)):
        fm.afm_gradients(params, tuple(x[order][None] for x in batch) + ((),), 0)
        got.append({n: t.grad.double() for n, t in params.named_parameters()})
    for n in ("v", "w", "b"):
        diff = (got[0][n] - got[1][n]).abs()
        assert (diff <= bound[n]).all(), n
        assert ((got[0][n] - exact[n]).abs() <= bound[n]).all(), n
        assert float(bound[n].max()) < 0.02 * float(got[0][n].abs().max())


def test_worst_entry_names_the_entry():
    want = fm.AFMParams(5, 2, [])
    got = fm.AFMParams(5, 2, [])
    with torch.no_grad():
        want.v.copy_(torch.ones(5, 2))
        got.v.copy_(torch.ones(5, 2))
        got.v[3, 1] = 1.5
    shares = cs.adam_epoch_shares(got, want)
    assert shares["v"]["share"] == pytest.approx(0.5)
    assert "(3, 1)" in shares["v"]["worst"] and "1 entries past" in shares["v"]["worst"]
    assert np.isclose(shares["w"]["share"], 0.0)


def _adam_epochs(a, b):
    """Each side's free-running Adam epoch from its init."""
    out = []
    for side in (a, b):
        params = side.fresh()
        side.epoch(params, side.optimizer("adam", params))
        out.append(params)
    return out


def test_adam_epoch_hold_passes_a_reordered_pair(rows):
    a, b = _sides(rows, sharded_a=True)
    got, want = _adam_epochs(a, b)
    slots = int(b.batches[0].shape[2])
    shares = cs.hold_adam_epoch("4 shards against one", got, want, slots)
    assert {n: x["past"] for n, x in shares.items()} == {"b": 0, "v": 0, "w": 0}
    assert shares["v"]["allowed"] == slots * HP["n_factors"] and shares["w"]["allowed"] == slots
    assert 0 < shares["v"]["share"] < cs.AFM_TOL


def test_adam_epoch_hold_allows_one_rows_entries(rows):
    """A row's ``slots`` features moved apart in every factor pass; one
    entry more fails."""
    a, b = _sides(rows, sharded_a=False)
    got, want = _adam_epochs(a, b)
    slots = int(b.batches[0].shape[2])
    with torch.no_grad():
        got.v[:slots] += 1.0
        got.w[:slots] += 1.0
    cs.hold_adam_epoch("one row apart", got, want, slots)
    with torch.no_grad():
        got.v[slots, 0] += 1.0
    with pytest.raises(RuntimeError, match="table v has"):
        cs.hold_adam_epoch("one row and an entry apart", got, want, slots)


@pytest.mark.parametrize("fault", ["own_weight_sum", "drop_shard", "adam_b2"])
def test_adam_epoch_hold_fails_on_each_fault(monkeypatch, rows, fault):
    a, b = _sides(rows, sharded_a=True)
    _plant(monkeypatch, fault, a)
    got, want = _adam_epochs(a, b)
    with pytest.raises(RuntimeError, match="Adam epoch: table v has"):
        cs.hold_adam_epoch("4 shards against one", got, want, int(b.batches[0].shape[2]))
