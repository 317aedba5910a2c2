"""The sharded master's AFM against a single card's, once per Python hash seed.

chip_smoke.py's phase 12 holds the master's data-parallel AFM fit (one epoch,
4 shards of one card) against a single-card master's fit on the same loaded
data, table by table, within ``AFM_TOL`` of each table's largest magnitude.
The master's CTR rows follow the iteration order of a set of (user, item)
strings, so each interpreter's hash seed gives them another order. This probe
runs that comparison in one process per ``PYTHONHASHSEED`` (``--jobs`` at a
time) on phase 12's data and prints each run's shares as a JSON line, then
the sorted ``v`` shares. With ``--repeat`` the first seed fits both models
twice and reports whether the card repeats them bit for bit. Where a ``v``
share passes ``AFM_TOL``, the run also prints the worst entry's history
(gradient, Adam moments, value) in the steps where the two fits part.

    python3 tools/sharded_afm_probe.py --seeds 0-17 --repeat
    python3 tools/sharded_afm_probe.py --seeds 3 --device cpu
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def fit_pair(device: str, repeat: bool) -> dict:
    """Phase 12's sharded and single-card AFM fits in this process."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gorse_tpu_torch.parallel.mesh import make_mesh
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.meta import MetaStore
    from gorse_tpu_torch.utils.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    t0 = time.perf_counter()
    data = cs.neighbor_store(0, embedding=False, user_fields=cs.USER_FIELDS, n_users=cs.CTR_USERS)
    cfg = Config()
    cfg.recommend.collaborative.type = "mf"
    cfg.recommend.ranker.type = "fm"
    cfg.recommend.ranker.recommenders = ["collaborative"]
    cfg.recommend.ranker.fit_epoch = 1
    mesh = make_mesh(cs.SHARDS, devices=[dev])
    trace = {"entry": None, "steps": []}
    adam_step = torch.optim.Adam.step

    def step(self, *args, **kwargs):
        out = adam_step(self, *args, **kwargs)
        if trace["entry"] is not None:
            v = next(p for p in self.param_groups[0]["params"] if p.dim() == 2 and p.shape[1] > 1)
            st, e = self.state[v], trace["entry"]
            trace["steps"].append((float(v.grad[e]), float(st["exp_avg"][e]),
                                   float(st["exp_avg_sq"][e]), float(v.detach()[e])))
        return out

    torch.optim.Adam.step = step
    with tempfile.TemporaryDirectory(prefix="afm_probe_") as tmp:
        def fit(name: str) -> dict:
            m = Master(cfg, data, MemoryCacheStore(), BlobStore(Path(tmp) / name), MetaStore(),
                       device=dev)
            m.training_mesh = (lambda: None) if name.startswith("single") else (lambda: mesh)
            m.train_click_through_rate(loaded)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return m.ctr_model.model_params.to_numpy()

        loaded = Master(cfg, data, MemoryCacheStore(), BlobStore(Path(tmp) / "load"), MetaStore(),
                        device=dev).load_dataset()
        a, b = fit("sharded"), fit("single")
        out = {"rows": len(loaded.ctr),
               "shares": {k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30))
                          for k in b},
               "max_abs_v": float(np.abs(b["v"]).max())}
        if repeat:
            a2, b2 = fit("sharded_again"), fit("single_again")
            out["repeats_bit_equal"] = {"sharded": all(np.array_equal(a[k], a2[k]) for k in a),
                                        "single": all(np.array_equal(b[k], b2[k]) for k in b)}
        if out["shares"]["v"] > cs.AFM_TOL:
            d = np.abs(a["v"] - b["v"])
            e = tuple(int(x) for x in np.unravel_index(d.argmax(), d.shape))
            out["worst"] = {"entry": e, "sharded": float(a["v"][e]), "single": float(b["v"][e])}
            trace["entry"] = e
            fit("sharded_traced")
            sharded_steps, trace["steps"] = trace["steps"], []
            fit("single_traced")
            parts, most = [], 0.0
            for t, (x, y) in enumerate(zip(sharded_steps, trace["steps"])):
                dv = abs(x[3] - y[3])
                if dv > 2 * most + 1e-9:
                    parts.append({"step": t, "grad": [x[0], y[0]], "exp_avg": [x[1], y[1]],
                                  "exp_avg_sq": [x[2], y[2]], "value": [x[3], y[3]]})
                most = max(most, dv)
            out["parting_steps"] = parts[-8:]
    out["seconds"] = time.perf_counter() - t0
    return out


def seed_list(text: str) -> list[int]:
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds += range(int(lo), int(hi or lo) + 1)
    return seeds


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", default="0-17", help="hash seeds, e.g. 0-17 or 3,5,9")
    parser.add_argument("--jobs", type=int, default=3, help="processes at a time")
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--repeat", action="store_true",
                        help="fit twice at the first seed and compare bit for bit")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        print("RESULT " + json.dumps(fit_pair(args.device, args.repeat)), flush=True)
        return 0
    pending, running, shares = list(enumerate(seed_list(args.seeds))), [], []
    n_seeds = len(pending)
    while pending or running:
        while pending and len(running) < args.jobs:
            n, seed = pending.pop(0)
            cmd = [sys.executable, __file__, "--one", "--device", args.device]
            cmd += ["--repeat"] if args.repeat and n == 0 else []
            running.append((seed, subprocess.Popen(
                cmd, env={**os.environ, "PYTHONHASHSEED": str(seed)},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        seed, proc = running.pop(0)
        stdout, stderr = proc.communicate()
        found = [x[7:] for x in stdout.splitlines() if x.startswith("RESULT ")]
        result = json.loads(found[0]) if found else {"rc": proc.returncode, "stderr": stderr[-2000:]}
        print(json.dumps({"hash_seed": seed, **result}), flush=True)
        if found:
            shares.append(result["shares"]["v"])
    print(json.dumps({"v_shares_sorted": sorted(shares), "runs": len(shares),
                      "past_afm_tol": sum(s > 1e-3 for s in shares)}))
    return 0 if len(shares) == n_seeds else 1


if __name__ == "__main__":
    sys.exit(main())
