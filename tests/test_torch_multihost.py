"""The port's training over several processes (gorse_tpu_torch/parallel/
multihost.py): two OS processes joined by ``torch.distributed`` over gloo on
127.0.0.1, each holding 2 CPU shards of one 4-shard mesh, run the
user-sharded and the catalog-sharded BPR epochs. The counterpart of
tests/test_multihost.py.

Sums run in global shard order, so the result must be bit-equal to a
one-process 4-shard mesh (run the same way, in a process of its own, on one
thread like the pair) and, within the sharded tests' tolerances, the
reference's 4-device mesh.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from gorse_tpu.data import synthetic_cf as ref_synthetic_cf
from gorse_tpu.parallel import catalog as RC
from gorse_tpu.parallel import make_mesh as ref_make_mesh
from gorse_tpu.parallel import sharded as RS

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

CHILD = """
import sys
import numpy as np
import torch

torch.set_num_threads(1)
from gorse_tpu_torch.data.loaders import synthetic_cf
from gorse_tpu_torch.ops import sampling
from gorse_tpu_torch.parallel import catalog, sharded
from gorse_tpu_torch.parallel.mesh import make_mesh
from gorse_tpu_torch.parallel.multihost import global_mesh, init_multihost

coord, world, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
if world > 1:
    info = init_multihost(coord, world, rank, devices=["cpu", "cpu"])
    assert info == {"process_index": rank, "process_count": world, "local_devices": 2,
                    "global_devices": 4}, info
    mesh = global_mesh(devices=["cpu", "cpu"])
else:
    mesh = make_mesh(4, devices=["cpu"])
assert mesh.size == 4

train, _ = synthetic_cf(n_users=93, n_items=70, rank=4, density=0.15, seed=3).split_cf(seed=0)
csr = train.padded_user_positives()
rng = np.random.default_rng(0)
p0 = rng.normal(scale=0.01, size=(train.count_users(), 8)).astype(np.float32)
q0 = rng.normal(scale=0.01, size=(train.count_items(), 8)).astype(np.float32)
n_items = train.count_items()

epoch = sharded.make_sharded_bpr_epoch(mesh, 5, n_items, 0.05, 0.01)
p, q, pp, pc, uids, n_users = sharded.shard_bpr_inputs(mesh, p0, q0, csr.padded, csr.counts)
p, q, cost = epoch(p, q, pp, pc, uids, sampling.prng_key(7))

cat = catalog.make_catalog_sharded_bpr_epoch(mesh, 5, n_items, 0.05, 0.01, slack=16.0)
cp, cq, cpp, cpc, cuids, _, _ = catalog.shard_catalog_bpr_inputs(mesh, p0, q0, csr.padded,
                                                                 csr.counts)
cp, cq, stats = cat(cp, cq, cpp, cpc, cuids, sampling.prng_key(7))
np.savez(out, p=mesh.all_gather(p)[0][:n_users].numpy(), q=q[0].numpy(), cost=cost.numpy(),
         cat_p=mesh.all_gather(cp)[0][:n_users].numpy(),
         cat_q=catalog.unpack_catalog(mesh.all_gather(cq)[0], n_items, 4),
         cat_stats=stats.numpy())
print("RESULT ok", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(script, coord, world, rank, out):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, str(script), coord, str(world), str(rank), str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)


def _reference():
    data = ref_synthetic_cf(n_users=93, n_items=70, rank=4, density=0.15, seed=3)
    train, _ = data.split_cf(seed=0)
    csr = train.padded_user_positives()
    rng = np.random.default_rng(0)
    p0 = rng.normal(scale=0.01, size=(train.count_users(), 8)).astype(np.float32)
    q0 = rng.normal(scale=0.01, size=(train.count_items(), 8)).astype(np.float32)
    mesh = ref_make_mesh(4, devices=jax.devices()[:4])
    epoch = RS.make_sharded_bpr_epoch(mesh, n_steps=5, n_items=train.count_items(), lr=0.05,
                                      reg=0.01)
    p, q, pp, pc, uids, n_users = RS.shard_bpr_inputs(mesh, p0, q0, csr.padded, csr.counts)
    p, q, cost = epoch(p, q, pp, pc, uids, jax.random.PRNGKey(7))
    cat = RC.make_catalog_sharded_bpr_epoch(mesh, n_steps=5, n_items=train.count_items(),
                                            lr=0.05, reg=0.01, slack=16.0)
    cp, cq, cpp, cpc, cuids, _, _ = RC.shard_catalog_bpr_inputs(mesh, p0, q0, csr.padded,
                                                                csr.counts)
    cp, cq, stats = cat(cp, cq, cpp, cpc, cuids, jax.random.PRNGKey(7))
    return {"p": np.asarray(p)[:n_users], "q": np.asarray(q), "cost": np.asarray(cost),
            "cat_p": np.asarray(cp)[:n_users],
            "cat_q": RC.unpack_catalog(np.asarray(cq), train.count_items(), 4),
            "cat_stats": np.asarray(stats)}


def test_two_process_sharded_epoch(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    coord = f"127.0.0.1:{_free_port()}"
    runs = {"rank0": (2, 0), "rank1": (2, 1), "one_process": (1, 0)}
    procs = {name: _spawn(script, coord, world, rank, tmp_path / f"{name}.npz")
             for name, (world, rank) in runs.items()}
    try:
        outs = {name: p.communicate(timeout=TIMEOUT_S)[0].decode() for name, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
    for name, out in outs.items():
        assert "RESULT ok" in out, f"{name} produced no result:\n{out[-3000:]}"
    got = {name: dict(np.load(tmp_path / f"{name}.npz")) for name in runs}
    for key, want in got["one_process"].items():
        for name in ("rank0", "rank1"):
            assert np.array_equal(got[name][key], want), (name, key)  # bit for bit

    ref = _reference()
    one = got["one_process"]
    assert one["cat_stats"][1] == ref["cat_stats"][1] == 0
    np.testing.assert_allclose(one["cost"], ref["cost"], rtol=1e-5)
    np.testing.assert_allclose(one["cat_stats"][0], ref["cat_stats"][0], rtol=1e-4)
    np.testing.assert_allclose(one["cat_stats"][0], one["cost"][0], rtol=1e-4)
    for key in ("p", "q", "cat_p", "cat_q"):
        np.testing.assert_allclose(one[key], ref[key], rtol=2e-4, atol=1e-6, err_msg=key)
    assert pytest.approx(float(one["q"].sum()), rel=1e-4) == float(ref["q"].sum())
