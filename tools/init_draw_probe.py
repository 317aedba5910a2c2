"""Times the inits' host draw (``prng.normal``) under variants, in one process.

    python3 tools/init_draw_probe.py [--root DIR] [--reps 3] [--chunks 1048576,262144]

``gorse_tpu_torch`` is imported from ``--root`` (default: this checkout).
The draw is BPR's two tables at the ml-20m shape (138,493 x 64 and 26,744 x
64, as ``MatrixFactorization.init`` draws them), its median host seconds
over ``--reps``, for each chunk size of ``--chunks`` (``prng._CHUNK``), and
once more with ``fma_f32`` taking a midpoint test first (the sum rounded
straight to f32 where no f64 sum lies on an f32 midpoint or below f32's
normal range, the rounding to odd where one does), to price that test. Each
variant's draw is checked bit for bit against the first. Prints one JSON
line with the host's thread count and the card's name and power limit
where ``nvidia-smi`` answers.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPES = ((138_493, 64), (26_744, 64))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--chunks", default="1048576,262144,65536")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from gorse_tpu_torch.ops import prng

    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
    except (OSError, IndexError):
        card = None
    keys = prng.split(prng.prng_key(0))

    def draw():
        return [prng.normal(k, s) for k, s in zip(keys, SHAPES)]

    def timed() -> tuple[float, list]:
        times, out = [], None
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = draw()
            times.append(time.perf_counter() - t0)
        return statistics.median(times), out

    exact = prng.fma_f32

    def midpoint_first(a, b, c):
        p = a.double() * (b.double() if torch.is_tensor(b) else b)
        s = p + (c.double() if torch.is_tensor(c) else c)
        bits = s.view(torch.int64)
        if not bool((((bits & 0x1FFFFFFF) == 0x10000000)
                     | ((bits & 0x7FFFFFFFFFFFFFFF) < 0x3810000000000000)).any()):
            return s.float()
        return exact(a, b, c)

    result = {"root": str(Path(args.root).resolve()), "card": card,
              "threads": torch.get_num_threads(), "cpus": os.cpu_count(),
              "values": sum(math.prod(s) for s in SHAPES), "seconds": {}}
    want = None
    for chunk in (int(x) for x in args.chunks.split(",")):
        prng._CHUNK = chunk
        seconds, got = timed()
        want = want or got
        result["seconds"][f"chunk {chunk}"] = seconds
        result.setdefault("equal", []).append(all(torch.equal(x, y) for x, y in zip(got, want)))
    prng.fma_f32 = midpoint_first
    seconds, got = timed()
    prng.fma_f32 = exact
    result["seconds"][f"chunk {prng._CHUNK}, midpoint test first"] = seconds
    result["equal"].append(all(torch.equal(x, y) for x, y in zip(got, want)))
    print(json.dumps(result))
    return 0 if all(result["equal"]) else 1


if __name__ == "__main__":
    sys.exit(main())
