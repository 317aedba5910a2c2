"""The AFM ranker of the port against gorse_tpu's, on the CPU.

Tolerances:
- ``afm_forward``: the two packages sum the same f32 products in another
  order, so each logit may differ by ``FORWARD_TOL`` (64 x 2^-24) times the
  logit's magnitude, the same forward over absolute values;
- one Adam or SGD step: optimizer moments within 1e-6 relative + 1e-9
  absolute (the gradients differ by summation order only); parameters
  within that plus ``lr`` x 2e-5 after an Adam step: optax rounds its bias
  corrections ``1 - 0.999^t`` in f32 (``1 - 0.999`` comes out 1.29e-5
  small), torch computes them in f64, so the first step's update differs
  by 6.4e-6 of ``lr``;
- a fit of a few epochs from the reference's injected init: Adam's update
  divides by the square root of the second moment, which carries those
  rounding differences into every step, so each table within ``FIT_TOL``
  (1e-3) of its largest magnitude and the AUC within ``AUC_TOL`` (2e-3);
- ``auc`` and the classification metrics on small inputs: the counts and
  rank sums are exact in f32, the ratios within 4 ulps (``METRIC_TOL``:
  XLA on the CPU divides by multiplying with a reciprocal, 15 / 50 comes
  out one ulp below 0.3).
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu.data.ctr import synthetic_ctr as ref_synthetic_ctr
from gorse_tpu.models import fm as ref_fm
from gorse_tpu.models.params import FitConfig as RefFitConfig
from gorse_tpu.models.params import Params as RefParams
from gorse_tpu.ops import metrics as ref_metrics
from gorse_tpu_torch.data import ctr
from gorse_tpu_torch.models import fm
from gorse_tpu_torch.models.params import FitConfig, Params
from gorse_tpu_torch.ops import metrics

FORWARD_TOL = 64 * 2.0**-24
FIT_TOL = 1e-3
AUC_TOL = 2e-3
METRIC_TOL = 4 * 2.0**-24


def flat_of(params: dict) -> dict:
    """The reference's parameter tree in the ``params.npz`` layout."""
    flat = {k: np.asarray(params[k]) for k in ("b", "v", "w")}
    for c, att in enumerate(params["att"]):
        for k, arr in att.items():
            flat[f"att{c}_{k}"] = np.asarray(arr)
    return flat


def ref_tree(flat: dict) -> dict:
    """``params.npz``-layout arrays as the reference's parameter tree."""
    n_towers = sum(1 for k in flat if k.endswith("_eb"))
    return {"b": jnp.asarray(flat["b"]), "v": jnp.asarray(flat["v"]),
            "w": jnp.asarray(flat["w"]),
            "att": [{k: jnp.asarray(flat[f"att{c}_{k}"]) for k in fm.TOWER_KEYS}
                    for c in range(n_towers)]}


def ref_init(params, n_features, dims, seed=0):
    """The reference AFM's init, drawn by ``jax.random``, as numpy."""
    return flat_of(ref_fm.AFM(RefParams(params))._init_params(n_features, dims, seed))


def inject(monkeypatch, scale=1.0):
    """Port fits start from the reference's init (times ``scale``)."""
    def init(self, n_features, dims, seed):
        flat = ref_init(dict(self.params), n_features, dims, seed)
        return fm.afm_params_from_numpy({k: v * scale for k, v in flat.items()}, self.device)

    monkeypatch.setattr(fm.AFM, "_init_params", init)


def _with_embeddings(d, dim, seed):
    rng = np.random.default_rng(seed)
    d.embedding_dims = [dim]
    d.embeddings = [[rng.normal(size=dim).astype(np.float32) for _ in range(len(d))]]
    return d


def _data(port: bool, n=600, seed=5, dim=0, numerical=False):
    make = ctr.synthetic_ctr if port else ref_synthetic_ctr
    d = make(n_samples=n, seed=seed, numerical=numerical)
    return _with_embeddings(d, dim, seed) if dim else d


def _table_share(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_params(port_params: fm.AFMParams, ref_params: dict, tol: float):
    flat = flat_of(ref_params)
    got = port_params.to_numpy()
    assert sorted(got) == sorted(flat)
    for name, want in flat.items():
        g = torch.as_tensor(got[name])
        share = _table_share(g, want)
        assert share <= tol, f"{name}: off by {share:.3g} of its largest magnitude"


# ---------------------------------------------------------------- forward


def _magnitude(flat, idx, val, embs):
    """The forward of absolute values: what each logit's rounding scales with."""
    absf = {k: np.abs(v).astype(np.float64) for k, v in flat.items()}
    v, w = absf["v"][idx], absf["w"][idx]
    x = np.abs(val).astype(np.float64)[..., None]
    vx = (v * x).sum(1)
    mag = (w[..., 0] * x[..., 0]).sum(1) + 0.5 * ((vx * vx).sum(1) + (v * v * x * x).sum((1, 2)))
    mag += float(absf["b"])
    for c, e in enumerate(embs):
        e = np.abs(e).astype(np.float64)
        enc = e @ absf[f"att{c}_ew"] + absf[f"att{c}_eb"]
        mag += (vx * enc).sum(1)
    return mag


@pytest.mark.parametrize("dim", [0, 6])
def test_afm_forward_is_the_reference(dim):
    data = _data(False, n=300, seed=2, dim=dim, numerical=True)
    pad = data.padded()
    flat = ref_init({"n_factors": 8, "init_stddev": 0.3}, data.num_features(),
                    data.embedding_dims)
    rng = np.random.default_rng(0)
    for k in flat:
        if k.startswith("att"):
            flat[k] = flat[k] * 30.0 + rng.normal(size=flat[k].shape).astype(np.float32) * 0.1
    params = fm.afm_params_from_numpy(flat, "cpu")
    want = np.asarray(ref_fm.afm_forward(
        ref_tree(flat), jnp.asarray(pad.indices), jnp.asarray(pad.values),
        [jnp.asarray(e) for e in pad.embeddings]))
    got = fm.afm_forward(params, torch.as_tensor(pad.indices).long(),
                         torch.as_tensor(pad.values),
                         [torch.as_tensor(e) for e in pad.embeddings]).detach().numpy()
    mag = _magnitude(flat, pad.indices, pad.values, pad.embeddings)
    assert np.all(np.abs(got - want) <= FORWARD_TOL * mag)
    assert np.abs(want).max() > 1.0  # the towers and interactions are not negligible


def test_pad_slots_add_nothing():
    """Padding (index 0, value 0) changes neither the logits nor v[0]'s
    gradient, whatever v[0] holds."""
    flat = {"b": np.float32(0.5), "v": np.random.default_rng(1).normal(size=(6, 4)).astype(
        np.float32), "w": np.ones((6, 1), np.float32)}
    params = fm.afm_params_from_numpy(flat, "cpu")
    idx = torch.tensor([[3, 4], [5, 2]])
    val = torch.tensor([[1.0, 2.0], [0.5, 1.0]])
    out = fm.afm_forward(params, idx, val)
    out.sum().backward()
    grad = params.v.grad.clone()
    params.zero_grad()
    out_pad = fm.afm_forward(params, torch.cat([idx, torch.zeros(2, 3, dtype=torch.long)], 1),
                             torch.cat([val, torch.zeros(2, 3)], 1))
    out_pad.sum().backward()
    assert torch.equal(out, out_pad)
    assert torch.equal(params.v.grad, grad) and not grad[0].any()


# ------------------------------------------------------------ one step


def _one_step(optimizer: str, dim: int):
    data = _data(False, n=256, seed=9, dim=dim, numerical=True)
    hp = {"n_factors": 4, "lr": 0.05, "reg": 0.01, "optimizer": optimizer, "init_stddev": 0.1}
    ref = ref_fm.AFM(RefParams(hp))
    flat = ref_init(hp, data.num_features(), data.embedding_dims)
    pad = data.padded()
    ref_batches = ref._batch(pad, 300)  # one batch with 44 zero-weight rows
    tx = ref._make_optimizer()
    params = ref_tree(flat)
    state = tx.init(params)
    ref_params, ref_state, ref_cost = ref_fm._afm_train_epoch(
        jax.tree.map(jnp.array, params), state, *ref_batches, optimizer=tx)

    port = fm.AFM(Params(hp), device="cpu")
    port.model_params = fm.afm_params_from_numpy(flat, "cpu")
    opt = port._make_optimizer()
    cost = fm.train_epoch(port.model_params, opt, port._batch(pad, 300))
    return ref_params, ref_state, float(ref_cost), port, opt, float(cost)


def _close(got, want, atol=1e-9):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=atol)


@pytest.mark.parametrize("dim", [0, 4])
def test_one_adam_step_is_optax(dim):
    ref_params, ref_state, ref_cost, port, opt, cost = _one_step("adam", dim)
    assert abs(cost - ref_cost) <= 1e-6 * abs(ref_cost)
    got = port.model_params.to_numpy()
    for name, want in flat_of(ref_params).items():
        _close(got[name], want, atol=port.lr * 2e-5)
    adam = ref_state[1]  # chain(add_decayed_weights, scale_by_adam, scale)
    assert int(adam.count) == 1
    pairs = [(port.model_params.b, adam.mu["b"], adam.nu["b"]),
             (port.model_params.v, adam.mu["v"], adam.nu["v"]),
             (port.model_params.w, adam.mu["w"], adam.nu["w"])]
    for c, tower in enumerate(port.model_params.att):
        pairs += [(getattr(tower, k), adam.mu["att"][c][k], adam.nu["att"][c][k])
                  for k in fm.TOWER_KEYS]
    for p, mu, nu in pairs:
        st = opt.state[p]
        assert int(st["step"]) == 1
        _close(st["exp_avg"], mu)
        _close(st["exp_avg_sq"], nu)
    # every row of v moved: its moment includes reg * v even without data
    assert np.all(np.asarray(adam.mu["v"]) != 0)


@pytest.mark.parametrize("dim", [0, 4])
def test_one_sgd_step_is_optax(dim):
    ref_params, _, ref_cost, port, opt, cost = _one_step("sgd", dim)
    assert isinstance(opt, torch.optim.SGD) and opt.defaults["momentum"] == 0.0
    assert abs(cost - ref_cost) <= 1e-6 * abs(ref_cost)
    got = port.model_params.to_numpy()
    for name, want in flat_of(ref_params).items():
        _close(got[name], want)


def test_defaults_are_the_reference():
    port, ref = fm.AFM(device="cpu"), ref_fm.AFM()
    for name in ("n_factors", "n_epochs", "lr", "reg", "init_mean", "init_stddev",
                 "optimizer_name", "batch_size", "auto_scale"):
        assert getattr(port, name) == getattr(ref, name), name
    assert (port.n_factors, port.n_epochs, port.lr, port.reg, port.batch_size) == (
        16, 50, 0.001, 0.0002, 1024)
    assert fm.AFM.PREDICT_CHUNK == ref_fm.AFM.PREDICT_CHUNK == 65536


def test_own_init_draws_the_same_distribution():
    model = fm.AFM(Params(n_factors=8, init_mean=0.5, init_stddev=0.02), device="cpu")
    params = model._init_params(4000, [500], seed=3)
    v = params.v.detach().numpy()
    assert abs(v.mean() - 0.5) < 1e-3 and abs(v.std() - 0.02) < 1e-3
    tower = params.att[0]
    assert float(params.b.detach()) == 0.0 and not tower.wb.any() and not tower.eb.any()
    for t in (tower.w, tower.h, tower.ew):
        assert abs(float(t.detach().std()) - 0.01) < 1e-3
    again = model._init_params(4000, [500], seed=3)
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), again.parameters()))


# --------------------------------------------------------------------- fit


@pytest.mark.parametrize("hp, dim", [
    ({"n_factors": 8, "n_epochs": 4, "lr": 0.01, "batch_size": 128}, 0),
    ({"n_factors": 4, "n_epochs": 3, "batch_size": 100}, 6),
    ({"n_factors": 4, "n_epochs": 3, "lr": 0.05, "batch_size": 64, "optimizer": "sgd"}, 0),
])
def test_fit_from_the_reference_init(monkeypatch, hp, dim):
    inject(monkeypatch)
    ref_data, data = _data(False, dim=dim, numerical=True), _data(True, dim=dim, numerical=True)
    ref_train, ref_test = ref_data.split(0.2, seed=1)
    train, test = data.split(0.2, seed=1)
    ref = ref_fm.AFM(RefParams(hp))
    want = ref.fit(ref_train, ref_test, RefFitConfig(verbose=1))
    port = fm.AFM(Params(hp), device="cpu")
    got = port.fit(train, test, FitConfig(verbose=1))
    _assert_params(port.model_params, ref.model_params, FIT_TOL)
    assert abs(got.auc - want.auc) <= AUC_TOL
    assert port.num_dimension == ref.num_dimension and port.embedding_dims == ref.embedding_dims
    assert {k: s.to_dict() for k, s in port.scalers.items()} == \
           {k: s.to_dict() for k, s in ref.scalers.items()} != {}


def _fit_messages(caplog, logger_name, fit):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger_name):
        score = fit()
    msgs = [r.getMessage() for r in caplog.records if r.name == logger_name]
    return score, [m for m in msgs if "early stopping" in m or "diverged" in m], \
        [int(m.split()[2].split("/")[0]) for m in msgs if m.startswith("fit afm")]


@pytest.mark.parametrize("hp, patience", [
    ({"n_factors": 4, "n_epochs": 12, "lr": 0.3, "batch_size": 64}, 2),  # early stopping
    ({"n_factors": 4, "n_epochs": 6, "lr": 1e20, "batch_size": 64,
      "optimizer": "sgd", "init_stddev": 10.0}, 0),  # diverges
])
def test_fit_stops_where_the_reference_stops(monkeypatch, caplog, hp, patience):
    inject(monkeypatch)
    ref_train, ref_test = _data(False, n=400).split(0.3, seed=2)
    train, test = _data(True, n=400).split(0.3, seed=2)
    want, ref_stops, ref_epochs = _fit_messages(caplog, ref_fm.logger.name, lambda: ref_fm.AFM(
        RefParams(hp)).fit(ref_train, ref_test, RefFitConfig(verbose=1, patience=patience)))
    got, stops, epochs = _fit_messages(caplog, fm.logger.name, lambda: fm.AFM(
        Params(hp), device="cpu").fit(train, test, FitConfig(verbose=1, patience=patience)))
    assert stops == ref_stops and len(stops) == 1
    assert epochs == ref_epochs and epochs[-1] < hp["n_epochs"]
    if patience:
        assert abs(got.auc - want.auc) <= AUC_TOL


# ----------------------------------------------------------------- metrics


def _auc_case(kind):
    rng = np.random.default_rng(4)
    labels = (rng.uniform(size=50) < 0.4).astype(np.float32)
    preds = rng.normal(size=50).astype(np.float32)
    valid = None
    if kind == "all_tied":
        preds = np.full(50, 0.25, np.float32)
    elif kind == "some_tied":
        preds = np.round(preds * 2) / 2
    elif kind == "all_positive":
        labels = np.ones(50, np.float32)
    elif kind == "all_negative":
        labels = np.zeros(50, np.float32)
    elif kind == "invalid_padded":
        preds = np.round(preds * 2) / 2
        valid = np.arange(50) < 37
        preds[37:] = 5.0  # padding above every valid score: must not count
        labels[37:] = 1.0
    elif kind == "perfect":
        preds = labels * 2 - 1
    return labels, preds, valid


@pytest.mark.parametrize("kind", ["random", "all_tied", "some_tied", "all_positive",
                                  "all_negative", "invalid_padded", "perfect"])
def test_classification_metrics_are_the_reference(kind):
    labels, preds, valid = _auc_case(kind)
    want = ref_metrics.classification_metrics(
        jnp.asarray(labels), jnp.asarray(preds), None if valid is None else jnp.asarray(valid))
    got = metrics.classification_metrics(
        torch.as_tensor(labels), torch.as_tensor(preds),
        None if valid is None else torch.as_tensor(valid))
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == torch.float32, name
        assert abs(float(got[name]) - float(want[name])) <= METRIC_TOL * abs(float(want[name])), (
            name, float(got[name]), float(want[name]))
    if kind in ("all_tied", "all_positive", "all_negative"):
        assert float(got["AUC"]) == 0.5
    if kind == "perfect":
        assert float(got["AUC"]) == 1.0


def test_auc_is_not_a_double_argsort():
    """Tied scores take their average rank: the AUC of fully tied inputs
    does not depend on the row order."""
    labels = torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0])
    for perm in ([0, 1, 2, 3, 4], [1, 3, 4, 0, 2]):
        assert float(metrics.auc(labels[perm], torch.zeros(5))) == 0.5


# ------------------------------------------------------------- inference


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A reference AFM fitted on numerical rows with an embedding column,
    saved, and the port's load of it."""
    path = tmp_path_factory.mktemp("afm") / "ref"
    data = _data(False, n=500, seed=7, dim=4, numerical=True)
    train, test = data.split(0.2, seed=0)
    ref = ref_fm.AFM(RefParams(n_factors=4, n_epochs=3, batch_size=64, init_stddev=0.2))
    ref.fit(train, test, RefFitConfig(verbose=3))
    ref.save(path)
    return ref, fm.AFM.load(path, device="cpu"), test, path


def test_predict_padded_chunks_match_one_shot(fitted):
    _, port, test, _ = fitted
    pad = test.padded(port.num_dimension)
    full = port.predict_padded(pad.indices, pad.values, pad.embeddings).numpy()
    port.PREDICT_CHUNK = 17  # many uneven chunks
    try:
        chunked = port.predict_padded(pad.indices, pad.values, pad.embeddings).numpy()
    finally:
        del port.PREDICT_CHUNK
    assert full.shape == (len(test),)
    assert np.array_equal(chunked, full)


def test_batch_predict_truncates_at_num_dimension(fitted):
    """Rows longer than the model's ``num_dimension`` are cut, as the
    reference cuts them; scalers and embeddings apply."""
    ref, port, test, _ = fitted
    rng = np.random.default_rng(3)
    rows = [test.features[i] for i in range(20)]
    rows += [(idx + rng.choice(ref.num_dimension * 4, size=3).tolist(), val + [2.5, 1.0, 0.5])
             for idx, val in rows[:10]]
    rows.append(([], []))
    embs = [[test.embeddings[0][i]] for i in range(20)] + [[None]] * 11
    want = np.asarray(ref.batch_predict(rows, embs))
    got = port.batch_predict(rows, embs)
    assert max(len(r[0]) for r in rows) > port.num_dimension
    assert got.dtype == np.float32 and got.shape == (31,)
    np.testing.assert_allclose(got, want, rtol=FORWARD_TOL * 4, atol=FORWARD_TOL * 4)


def test_saved_models_load_both_ways(fitted, tmp_path):
    """The reference's save loads in the port and the port's save in the
    reference: the same arrays (``b`` 0-d, the tower keys in order), the
    same meta.json, the same predictions."""
    ref, port, test, path = fitted
    port.save(tmp_path / "port")
    assert (tmp_path / "port" / "meta.json").read_text() == (path / "meta.json").read_text()
    with np.load(tmp_path / "port" / "params.npz") as a, np.load(path / "params.npz") as b:
        assert list(a.keys()) == list(b.keys())
        assert a["b"].shape == () and b["b"].shape == ()
        for name in b.keys():
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name
    back = ref_fm.AFM.load(tmp_path / "port")
    rows = [test.features[i] for i in range(30)]
    embs = [[test.embeddings[0][i]] for i in range(30)]
    np.testing.assert_array_equal(np.asarray(back.batch_predict(rows, embs)),
                                  np.asarray(ref.batch_predict(rows, embs)))
    assert json.loads((path / "meta.json").read_text())["scalers"]


def test_direct_index_models_load_both_ways(tmp_path, monkeypatch):
    """A model over a libFM file (``DirectIndex``): the port fits and saves
    it, the reference loads it, and back."""
    inject(monkeypatch)
    p = tmp_path / "train.libfm"
    rng = np.random.default_rng(0)
    p.write_text("".join(f"{int(rng.uniform() < 0.5)} {rng.integers(0, 5)}:1 "
                         f"{rng.integers(5, 12)}:{rng.integers(1, 4)}\n" for _ in range(200)))
    train, test = ctr.load_libfm(str(p), str(p))
    port = fm.AFM(Params(n_factors=4, n_epochs=2, batch_size=32), device="cpu")
    port.fit(train, test, FitConfig(verbose=0))
    port.save(tmp_path / "direct")
    ref = ref_fm.AFM.load(tmp_path / "direct")
    assert type(ref.index).__name__ == "DirectIndex" and ref.index.n == 12
    again = fm.AFM.load(tmp_path / "direct", device="cpu")
    assert isinstance(again.index, ctr.DirectIndex)
    rows = train.features[:16]
    np.testing.assert_allclose(np.asarray(ref.batch_predict(rows)), again.batch_predict(rows),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(again.batch_predict(rows), port.batch_predict(rows))
