"""K1 (``bpr_epoch``) under other occupancies and grids, in turns on one card.

``csrc/bpr.cu`` sets K1's co-resident blocks an SM at compile time
(``epoch_min_blocks`` in ``__launch_bounds__``) and its cooperative grid at
launch (``launch_epoch_kpl``). This probe builds variants of the source that
differ only there, plus, with ``--parent``, another checkout's ``bpr.cu``,
one ``nvcc`` each, all started together. It then times a whole epoch of each
variant, in turns (forward, then backward, ``--rounds`` times; CUDA-event
medians), at chip_smoke.py's shapes:

- ``p5k64``: phase 4/5's corpus (138k x 27k), k = 64, against the rows;
- ``p5k32``: the same corpus at k = 32 (the k <= 32 instance);
- ``p18rows`` / ``p18bits``: phase 18's quality-gate corpus (6,040 x 3,706),
  k = 8, against the rows and against the full-set bitset.

A variant is ``BOUNDS:GRID``. BOUNDS is ``tiers`` (the source's own
``epoch_min_blocks``), ``free`` (no minimum: ptxas chooses the registers) or
a number of blocks an SM for every width. GRID is ``source`` (the source's
own ``epoch_users``), a number N (the grid capped so that a warp takes at
least N users: 1 leaves every block that fits at these shapes) or ``R/B``
(R users a warp against the rows, B against the bitset). ``parent`` is the
other checkout's source as it stands. Each instance's registers and spills come from ptxas. The result
is one JSON line, also written to ``--out``.

    python3 tools/k1_occupancy_probe.py --parent build/parent \\
        --variants tiers:source,tiers:1,free:1,3:32/4
"""
import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BOUNDS_LINE = "__launch_bounds__(THREADS, epoch_min_blocks(KPL))"
USERS_RE = re.compile(r"(int epoch_users\(const SweepArgs& a\) \{\n)(  return [^\n]*\n)")


def variant_source(spec: str, source: str) -> str:
    bounds, grid = spec.split(":")
    if BOUNDS_LINE not in source or not USERS_RE.search(source):
        raise SystemExit("bpr.cu no longer has the lines this probe rewrites")
    if bounds == "free":
        source = source.replace(BOUNDS_LINE, "__launch_bounds__(THREADS)")
    elif bounds != "tiers":
        source = source.replace(BOUNDS_LINE, f"__launch_bounds__(THREADS, {int(bounds)})")
    if grid != "source":
        users = grid.split("/")
        rule = (f"a.bits != nullptr ? {int(users[1])} : {int(users[0])}" if len(users) == 2
                else str(int(users[0])))
        source = USERS_RE.sub(lambda m: m.group(1) + f"  return {rule};\n", source, count=1)
    return source


def ptxas_epoch(log: str) -> dict:
    """Registers and spill bytes of each bpr_epoch_kernel instance, by its
    template arguments (BF16, KPL, VEC)."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if "bpr_epoch_kernel" in m.group(1) else None
            continue
        if entry is None:
            continue
        t = re.search(r"ILb(\d)ELi(\d+)ELb(\d)E", entry)
        name = f"bf16={t.group(1)},kpl={t.group(2)},vec={t.group(3)}" if t else entry
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {})["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def build_all(sources: dict, workdir: Path) -> dict:
    from gorse_tpu_torch.ops import _build

    workdir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        src = workdir / f"bpr_{name}.cu"
        src.write_text(text)
        lib = workdir / f"libbpr_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        out[name] = (lib, ptxas_epoch(log))
    return out


def shapes(dev):
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gorse_tpu_torch.data.loaders import synthetic_cf_powerlaw
    from gorse_tpu_torch.models import BPR, Params
    from gorse_tpu_torch.models import bpr as bpr_model
    from gorse_tpu_torch.ops import sampling

    def epoch_args(train, csr, k, bits):
        n_items = train.count_items()
        n_active = max(int((csr.counts > 0).sum()), 1)
        init = BPR(Params(n_factors=k), device=dev)
        init.init(train, seed=0)
        return dict(p=init.user_factors, q=init.item_factors,
                    padded=torch.as_tensor(csr.padded, device=dev),
                    counts=torch.as_tensor(csr.counts, device=dev),
                    keys=sampling.raw_step_keys(sampling.prng_key(1),
                                                max(round(train.count_feedback() / n_active), 1)),
                    n_items=n_items, bits=bits,
                    n_tries=bpr_model.adaptive_neg_tries(float(np.mean(csr.counts)) / n_items))

    out = {}
    train, _, csr = cs.make_training_data()
    for k in (64, 32):
        out[f"p5k{k}"] = epoch_args(train, csr, k, None)
    del train, csr
    train, _ = synthetic_cf_powerlaw(seed=cs.POWERLAW_SEED).split_cf(seed=0)
    cap, _ = bpr_model.history_cap(train)
    csr = train.padded_user_positives(max_len=cap, seed=0)
    bits = torch.from_numpy(train.positives_bitset().view(np.int32)).to(dev)
    out["p18rows"] = epoch_args(train, csr, cs.POWERLAW_BPR["n_factors"], None)
    out["p18bits"] = dict(out["p18rows"], bits=bits)
    return out, cs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default="tiers:source,tiers:1,free:1")
    parser.add_argument("--parent", type=Path, default=None,
                        help="root of another checkout whose bpr.cu runs as 'parent'")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "k1_occupancy.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k1_occupancy_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gorse_tpu_torch.ops import _build
    from gorse_tpu_torch.ops import bpr_kernel as bk

    source = (_build.CSRC / "bpr.cu").read_text()
    sources = {spec.replace(":", "-").replace("/", "_"): variant_source(spec, source)
               for spec in args.variants.split(",")}
    if args.parent is not None:
        sources["parent"] = (args.parent / "gorse_tpu_torch" / "csrc" / "bpr.cu").read_text()
    t0 = time.perf_counter()
    built = build_all(sources, ROOT / "build" / "k1_probe")
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cases, cs = shapes(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    libs = {name: ctypes.CDLL(str(lib)) for name, (lib, _) in built.items()}
    times = {name: {case: [] for case in cases} for name in libs}
    order = list(libs)
    for r in range(args.rounds):
        for name in order + order[::-1]:
            _build._loaded["bpr"] = libs[name]
            for case, c in cases.items():
                q = c["q"].clone()
                times[name][case].append(cs.median_ms(lambda: bk.bpr_epoch_fused(
                    c["p"], q, c["padded"], c["counts"], c["keys"], c["n_items"], cs.LR, cs.REG,
                    mm_dtype=torch.float32, n_tries=c["n_tries"], bits=c["bits"]), args.reps))
    result = {"card": smi, "build_s": build_s,
              "steps": {case: len(c["keys"]) for case, c in cases.items()},
              "variants": {name: {"ptxas": built[name][1],
                                  "ms": {case: [round(t, 4) for t in ts]
                                         for case, ts in times[name].items()},
                                  "median_ms": {case: round(statistics.median(ts), 4)
                                                for case, ts in times[name].items()}}
                           for name in libs}}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    for name, v in result["variants"].items():
        print(name, json.dumps(v["median_ms"]), json.dumps(
            {i: (p.get("registers"), p.get("spill")) for i, p in v["ptxas"].items()
             if "bf16=0" in i}), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
