"""Times the AFM's Adam epoch and the inits' draw of the tree it imports.

    python3 tools/afm_step_probe.py [--root DIR] [--reps 5] [--out FILE]

``gorse_tpu_torch`` is imported from ``--root`` (default: this checkout), so
another tree unpacked beside it (a parent commit, from ``git archive``) is
timed by the same script, in the same call:
- the AFM's epoch under its default optimizer (Adam) at two shapes, from
  the init of seed 0: chip_smoke.py phase 9's stage_afm rows (``synthetic_ctr``
  of 2,000 users and items, 131,072 samples: 4,050 features, 4 slots; k = 8,
  batch 1024, 128 steps) and the master's CTR fit (5,754 features, 8 slots,
  k = 16, batch 1024, 507 steps; rows drawn from ``--seed``, every slot
  filled, value 1, targets half positive). Each: the median of ``--reps``
  epochs by CUDA events, and the kernels of one epoch with their summed
  device ms from a ``torch.profiler`` trace;
- the inits' draw: ``prng.normal`` of BPR's two tables at the ml-20m shape
  (138,493 x 64 and 26,744 x 64, as ``MatrixFactorization.init`` draws
  them on the host): the median host seconds of ``--reps``.
Prints one JSON line with the card's name and power limit (and writes it
to ``--out`` when given). Needs a CUDA device.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

STAGE = {"n_users": 2000, "n_items": 2000, "n_samples": 131_072, "seed": 0}
MASTER = {"features": 5754, "slots": 8, "k": 16, "steps": 507}
BATCH = 1024
BPR_SHAPES = ((138_493, 64), (26_744, 64))


def epoch_times(torch, fm, params, batches, reps: int) -> dict:
    """Median CUDA-event ms of ``reps`` Adam epochs from ``params``, and one
    epoch's kernels and device ms from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    opt = fm.make_optimizer("adam", params.parameters(), 0.001, 0.0002)
    fm.train_epoch(params, opt, batches)  # warm-up
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fm.train_epoch(params, opt, batches)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fm.train_epoch(params, opt, batches)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    n_steps = int(batches[0].shape[0])
    device_ms = sum(e.device_time for e in kernels) / 1e3 if kernels else None
    epoch_ms = statistics.median(times)
    return {"steps": n_steps, "epoch_ms": epoch_ms, "epoch_ms_all": times,
            "ms_per_step": epoch_ms / n_steps, "kernels_per_step": len(kernels) / n_steps,
            "device_ms": device_ms,
            "device_busy_share": None if device_ms is None else device_ms / epoch_ms}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from gorse_tpu_torch.data.ctr import synthetic_ctr
    from gorse_tpu_torch.models import fm
    from gorse_tpu_torch.ops import prng

    if not torch.cuda.is_available():
        print("afm_step_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    result = {"root": str(Path(args.root).resolve()), "module": fm.__file__, "card": card}

    rows = synthetic_ctr(**STAGE)
    model = fm.AFM({"n_factors": 8, "batch_size": BATCH}, device=dev)
    batches = model._batch(rows.padded(rows.max_dimension()), BATCH)
    params = model._init_params(rows.num_features(), [], 0)
    result["stage"] = {"features": rows.num_features(), "slots": int(batches[0].shape[2]), "k": 8,
                       **epoch_times(torch, fm, params, batches, args.reps)}

    rng = np.random.default_rng(args.seed)
    n = MASTER["steps"] * BATCH
    idx = torch.from_numpy(rng.integers(0, MASTER["features"], (MASTER["steps"], BATCH,
                                                                  MASTER["slots"])))
    batches = (idx.to(dev), torch.ones(idx.shape, device=dev),
               torch.from_numpy(rng.integers(0, 2, n).astype(np.float32)).reshape(
                   MASTER["steps"], BATCH).to(dev),
               torch.ones(MASTER["steps"], BATCH, device=dev), ())
    model = fm.AFM({"n_factors": MASTER["k"], "batch_size": BATCH}, device=dev)
    params = model._init_params(MASTER["features"], [], 0)
    result["master"] = {**MASTER, **epoch_times(torch, fm, params, batches, args.reps)}

    times = []
    for _ in range(args.reps):
        k1, k2 = prng.split(prng.prng_key(0))
        t0 = time.perf_counter()
        for key, shape in zip((k1, k2), BPR_SHAPES):
            prng.normal(key, shape)
        times.append(time.perf_counter() - t0)
    result["bpr_init"] = {"shapes": BPR_SHAPES, "seconds": statistics.median(times),
                          "seconds_all": times}
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
