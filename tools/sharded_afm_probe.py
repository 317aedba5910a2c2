"""chip_smoke.py's three AFM comparisons, over many data orders.

chip_smoke.py compares two one-epoch AFM fits three times: phase 9's epoch at
bench.py stage_afm's shape on the card against the CPU (``stage``), phase 9's
master fit on the card against the CPU (``master``), and phase 12's master on
4 shards of the card against one card (``sharded``). The two fits of a pair
sum their gradients in another order, so they differ by rounding, and Adam
divides each step by the root of its second moment.

``--mode adam`` fits both sides free-running under Adam, as the comparisons
did before they were restated, and prints each table's share of its largest
magnitude (``AFM_TOL`` is the old hold). With ``--trace`` it keeps every
step's gradient (decay included), moments and value of table ``v`` on both
sides and prints, for the step where the two fits moved furthest apart in
one step and for the worst final entry: both sides' g, sqrt(v_hat) and the
sign of each side's step.

``--mode holds`` runs chip_smoke.py's restated holds (the lockstep under
Adam, the epoch under SGD, over the whole epoch) and ``hold_adam_epoch``
on each side's free-running Adam epoch from its init (entries past
``AFM_TOL`` within one row's), and prints the shares; a failed hold is a
failed order.

``--mode grads`` takes every step's gradients on both sides from the init
(no optimizer), twice on the side under test, and holds each against the
step's f64 gradients (``afm_grad_bound``) and the two evaluations against
each other bit for bit: it counts the entries past the bound, names the
first few, and counts the steps whose two evaluations differ.

A data order is a permutation of the comparison's rows drawn from the order
number (order 0 keeps the rows as the master builds them); the master's
0.2 split then picks other rows as well. The master's CTR rows follow a
set's order, which the interpreter's hash seed decides, so the probe runs
under ``PYTHONHASHSEED = --hash-seed`` (0 by default): an order then
names the same rows in any run. ``--users`` widens the master's
CTR rows past chip_smoke.py's ``CTR_USERS`` (6,040 is all of ml-1m).

    python3 tools/sharded_afm_probe.py --compare sharded --orders 0-199 --mode holds
    python3 tools/sharded_afm_probe.py --compare master,stage --orders 0-49 --mode adam --trace
    python3 tools/sharded_afm_probe.py --compare stage --orders 0-3 --device cpu
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TABLES = ("b", "v", "w")


def order_of(n: int, n_rows: int) -> np.ndarray:
    """Data order ``n``: the identity for 0, else a permutation from ``n``."""
    if n == 0:
        return np.arange(n_rows)
    return np.random.default_rng(n).permutation(n_rows)


class Tracer:
    """Wraps every optimizer ``make_optimizer`` builds so that each step
    keeps table ``v``'s decayed gradient, moments and value (on the host).
    Each fit appends one trace."""

    def __init__(self, fm) -> None:
        self.fm, self.traces, self.on = fm, [], False
        self.make = fm.make_optimizer

        def make(name, params, lr, reg):
            params = list(params)
            opt = self.make(name, params, lr, reg)
            if self.on:
                self._wrap(opt, params, reg)
            return opt

        fm.make_optimizer = make

    def _wrap(self, opt, params, reg) -> None:
        v = next(p for p in params if p.dim() == 2 and p.shape[1] > 1)
        trace = {"g": [], "p": [], "m": [], "v2": []}
        self.traces.append(trace)
        step = opt.step

        def traced(*args, **kwargs):
            g = v.grad.detach().double() + reg * v.detach().double()
            out = step(*args, **kwargs)
            st = opt.state[v]
            m = st.get("exp_avg", st.get("mu"))
            v2 = st.get("exp_avg_sq", st.get("nu"))
            trace["g"].append(g.float().cpu().numpy())
            trace["p"].append(v.detach().cpu().numpy().copy())
            trace["m"].append(m.detach().cpu().numpy().copy())
            trace["v2"].append(v2.detach().cpu().numpy().copy())
            return out

        opt.step = traced


def parting(a: dict, b: dict, p0: np.ndarray, b2: float = 0.999) -> dict:
    """Where two traced fits (``a`` the side under test, ``b`` the
    reference) part: the step and entry whose difference grew most in one
    step, and the final worst entry's steps that grew it most. Each as both
    sides' g, sqrt(v_hat), the sign of each side's step and the values."""
    pa, pb = np.stack(a["p"]), np.stack(b["p"])
    prev_a = np.concatenate([p0[None], pa[:-1]])
    prev_b = np.concatenate([p0[None], pb[:-1]])
    diff = np.abs(pa - pb)
    grew = diff - np.abs(prev_a - prev_b)
    t_idx = np.arange(1, len(pa) + 1)

    def at(t: int, e: tuple) -> dict:
        vhat = [float(np.sqrt(x["v2"][t][e] / (1 - b2 ** (t + 1)))) for x in (a, b)]
        return {"step": int(t), "entry": [int(i) for i in e],
                "g": [float(a["g"][t][e]), float(b["g"][t][e])], "sqrt_vhat": vhat,
                "m": [float(a["m"][t][e]), float(b["m"][t][e])],
                "step_sign": [int(np.sign(pa[t][e] - prev_a[t][e])),
                              int(np.sign(pb[t][e] - prev_b[t][e]))],
                "moved": [float(pa[t][e] - prev_a[t][e]), float(pb[t][e] - prev_b[t][e])],
                "value": [float(pa[t][e]), float(pb[t][e])],
                "apart": float(diff[t][e])}

    flat = int(grew.argmax())
    t, *e = np.unravel_index(flat, grew.shape)
    worst = tuple(int(i) for i in np.unravel_index(int(diff[-1].argmax()), diff[-1].shape))
    steps = np.argsort(grew[(slice(None),) + worst])[::-1][:4]
    # flips: one step that moves the two sides the opposite way, by more
    # than a tenth of what the larger move of the pair could be
    da, db = pa - prev_a, pb - prev_b
    flips = (np.sign(da) != np.sign(db)) & (np.maximum(np.abs(da), np.abs(db)) > 1e-4)
    out = {"steps": int(t_idx[-1]), "largest_one_step": at(int(t), tuple(e)),
           "worst_final": [at(int(s), worst) for s in sorted(steps)],
           "flips": int(flips.sum())}
    if flips.any():
        gap = np.where(flips, np.abs(da - db), 0.0)
        t, *e = np.unravel_index(int(gap.argmax()), gap.shape)
        out["largest_flip"] = at(int(t), tuple(e))
    return out


def grad_check(cs, a_spec, b_spec) -> dict:
    """Every step's gradients of both sides from the init against the f64
    gradients, and side a's two evaluations against each other."""
    import torch

    a, b = cs.AfmSide(*a_spec), cs.AfmSide(*b_spec)
    pa, pb = a.fresh(), b.fresh()
    grad_a, grad_b = a.gradients(pa), b.gradients(pb)
    p0 = {n: t.detach().cpu().double() for n, t in pb.named_parameters()}
    past, notes, unequal = 0, [], 0
    for s in range(b.n_steps):
        grad_a(s)
        if a.model.device.type == "cuda":  # the CPU's threads sum in any order
            first = {n: t.grad.clone() for n, t in pa.named_parameters()}
            grad_a(s)
            unequal += any(not torch.equal(first[n], t.grad) for n, t in pa.named_parameters())
        grad_b(s)
        batch = tuple(x[s].cpu() for x in b.batches[:4])
        for side, x, params in (("a", a, pa), ("b", b, pb)):
            exact, bound = cs.afm_grad_bound(p0, batch, (x.logits(params, s) == 0).cpu())
            for n, t in params.named_parameters():
                off = (t.grad.detach().cpu().double() - exact[n]).abs()
                bad = off > bound[n]
                past += int(bad.sum())
                if bad.any() and len(notes) < 8:
                    e = tuple(int(i) for i in np.unravel_index(int((off / bound[n].clamp(
                        min=1e-300)).argmax()), off.shape)) if off.dim() else ()
                    idx = b.batches[0][s].cpu()
                    notes.append({"step": s, "side": side, "table": n, "entry": list(e),
                                  "got": float(t.grad.detach().cpu()[e]),
                                  "f64": float(exact[n][e]), "bound": float(bound[n][e]),
                                  "slots": int((idx == e[0]).sum()) if e else None})
    return {"steps": b.n_steps, "past_bound": past, "unequal_repeats": unequal,
            "notes": notes}


def shares_of(a: dict, b: dict) -> dict:
    return {k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)) for k in b}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compare", default="sharded", help="sharded, master, stage")
    parser.add_argument("--orders", default="0-9", help="data orders, e.g. 0-199 or 3,5")
    parser.add_argument("--mode", default="holds", choices=("adam", "holds", "grads"))
    parser.add_argument("--trace", action="store_true", help="trace v's steps (adam mode)")
    parser.add_argument("--users", type=int, default=None, help="the master's CTR users")
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--out", default=None, help="also write the JSON lines here")
    parser.add_argument("--threads", type=int, default=None, help="torch's CPU threads")
    parser.add_argument("--hash-seed", default="0", help="PYTHONHASHSEED to run under")
    args = parser.parse_args()
    if os.environ.get("PYTHONHASHSEED") != args.hash_seed:
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": args.hash_seed})

    import torch

    if args.threads:
        torch.set_num_threads(args.threads)

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gorse_tpu_torch.models import fm
    from gorse_tpu_torch.models.params import FitConfig, Params
    from gorse_tpu_torch.parallel.mesh import make_mesh
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.meta import MetaStore
    from gorse_tpu_torch.utils.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    mesh = make_mesh(cs.SHARDS, devices=[dev])
    orders = []
    for part in args.orders.split(","):
        lo, _, hi = part.partition("-")
        orders += range(int(lo), int(hi or lo) + 1)
    tracer = Tracer(fm)
    tracer.on = args.trace and args.mode == "adam"
    out = open(args.out, "a") if args.out else None

    def emit(obj: dict) -> None:
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    kinds = args.compare.split(",")
    loaded = None
    if {"master", "sharded"} & set(kinds):
        t0 = time.perf_counter()
        data = cs.neighbor_store(0, embedding=False, user_fields=cs.USER_FIELDS,
                                 n_users=args.users or cs.CTR_USERS)
        cfg = Config()
        cfg.recommend.ranker.type = "fm"
        loaded = Master(cfg, data, MemoryCacheStore(), BlobStore(Path("build") / "afm_probe"),
                        MetaStore(), device=dev).load_dataset()
        emit({"loaded_rows": len(loaded.ctr), "seconds": time.perf_counter() - t0})
    stage = cs.afm_rows() if "stage" in kinds else None

    def sides(kind: str, n: int):
        """(name, side under test, reference side) for ``kind`` at order n:
        each side (device, mesh, AFM, train rows, test rows)."""
        if kind == "stage":
            rows = stage._take(order_of(n, len(stage)))
            hp = {"n_factors": cs.AFM_K, "batch_size": cs.AFM_BATCH}
            return ((dev, None, hp, rows, None), ("cpu", None, hp, rows, None))
        ctr = loaded.ctr._take(order_of(n, len(loaded.ctr)))
        train, test = ctr.split(0.2, seed=0)
        hp = {"n_epochs": 1}
        if kind == "master":
            return ((dev, None, hp, train, test), ("cpu", None, hp, train, test))
        return ((dev, mesh, hp, train, test), (dev, None, hp, train, test))

    def adam_fit(side) -> dict:
        device, m, hp, train, test = side
        model = fm.AFM(Params(hp), device=device)
        if test is None:  # stage_afm's epoch from the init, as hold_afm runs it
            pad = train.padded(train.max_dimension())
            params = model._init_params(train.num_features(), [], 0)
            opt = fm.make_optimizer(model.optimizer_name, params.parameters(), model.lr, model.reg)
            fm.train_epoch(params, opt, model._batch(pad, cs.AFM_BATCH))
            return params.to_numpy()
        model.fit(train, test, FitConfig(verbose=10, mesh=m))
        return model.model_params.to_numpy()

    shares_v, failed, t_all = [], 0, time.perf_counter()
    for kind in kinds:
        for n in orders:
            t0 = time.perf_counter()
            a_side, b_side = sides(kind, n)
            rec = {"compare": kind, "order": n}
            if args.mode == "grads":
                rec.update(grad_check(cs, a_side, b_side))
                failed += bool(rec["past_bound"] or rec["unequal_repeats"])
                rec["seconds"] = time.perf_counter() - t0
                emit(rec)
                continue
            tracer.traces = []
            if args.mode == "holds":
                sa, sb = cs.AfmSide(*a_side), cs.AfmSide(*b_side)
                try:
                    rec["holds"] = cs.afm_holds(kind, sa, sb)
                except RuntimeError as e:
                    rec["failed"] = str(e)
                    failed += 1
                # the free-running Adam epoch of each side, from its init
                fits = []
                for x in (sa, sb):
                    params = x.fresh()
                    x.epoch(params, x.optimizer("adam", params))
                    fits.append(params)
                try:
                    cs.hold_adam_epoch(kind, *fits, int(sb.batches[0].shape[2]))
                except RuntimeError as e:
                    rec["failed"] = f"{rec.get('failed', '')} {e}".strip()
                    failed += "holds" in rec
                a, b = ({**x.init, **f.to_numpy()} for x, f in zip((sa, sb), fits))
            else:
                a, b = adam_fit(a_side), adam_fit(b_side)
            rec["adam_shares"] = shares_of(a, b)
            rec["past_afm_tol"] = {k: int((np.abs(a[k] - b[k]) > cs.AFM_TOL * np.abs(b[k]).max())
                                          .sum()) for k in b}
            if len(tracer.traces) == 2:
                model = fm.AFM(Params(a_side[2]), device="cpu")
                p0 = model._init_params(a_side[3].num_features(), [], 0).to_numpy()["v"]
                rec["parting"] = parting(tracer.traces[0], tracer.traces[1], p0)
            rec["seconds"] = time.perf_counter() - t0
            shares_v.append(rec["adam_shares"]["v"])
            emit(rec)
    emit({"adam_v_shares_sorted": sorted(shares_v), "runs": len(shares_v),
          "adam_past_afm_tol": sum(s > cs.AFM_TOL for s in shares_v),
          "holds_failed": failed, "seconds": time.perf_counter() - t_all})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
