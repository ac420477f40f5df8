"""The port's ``make_sharded_sketch_step`` on 4 gloo CPU ranks against the
JAX package's on a 4-device virtual CPU mesh (a subprocess, as
tests/test_parallel.py runs it), at (8, 4, 1) and (12, 6, 3).

Both meshes are (2, 2) and order their shards row major.  The inputs
are halo'd blocks of one seeded genome with N runs, one shard's rows
all invalid (total 0).  At (8, 4, 1) the cap is below most shards'
totals; at (12, 6, 3) (a 36-bit hash) it is above them, so the slots
past ``total`` (the clamped searchsorted) are compared too.  Every rank
must return all four outputs exactly equal to the JAX step's (tolerance
0: integers).
"""

import json
import os

import numpy as np
import pytest

from conftest import run_in_cpu_mesh
from torch_ranks import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (half_k, half_subk, drlevel) -> (blocks a shard, block, cap)
CASES = {(8, 4, 1): (2, 1024, 64), (12, 6, 3): (2, 4096, 64)}

_JAX = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
from rabbitkssd_tpu.params import KssdParams
from rabbitkssd_tpu.parallel.sharded import make_mesh, make_sharded_sketch_step
from rabbitkssd_tpu.shuffle import generate_shuffle

(k, s, l), (nb, block, cap), work = json.loads(sys.argv[1])
codes = np.load(work + "/codes.npy")
mesh = make_mesh(4)
assert mesh.devices.shape == (2, 2)
step = make_sharded_sketch_step(KssdParams(k, s, l), mesh, nb, block, cap)
table = generate_shuffle(k, s, l).shuffled_dim.astype(np.int32)
out = step(codes, jnp.asarray(table))
np.savez(work + "/jax.npz", **dict(zip(("h_lo", "h_hi", "pos", "total"),
                                       (np.asarray(x) for x in out))))
"""

_PORT = r"""
import json, sys
import numpy as np
import torch
from rabbitkssd_tpu_torch.params import KssdParams
from rabbitkssd_tpu_torch.parallel.multihost import init_multihost, rank, shutdown
from rabbitkssd_tpu_torch.parallel.sharded import make_mesh, make_sharded_sketch_step
from rabbitkssd_tpu_torch.shuffle import generate_shuffle

(k, s, l), (nb, block, cap), work = json.loads(sys.argv[1])
assert init_multihost()
mesh = make_mesh()
assert (mesh.dp, mesh.vp) == (2, 2)
codes = np.load(work + "/codes.npy")
step = make_sharded_sketch_step(KssdParams(k, s, l), mesh, nb, block, cap)
table = torch.from_numpy(generate_shuffle(k, s, l).shuffled_dim.astype(np.int32))
out = step(codes, table)
np.savez(work + f"/rank{rank()}.npz", **dict(zip(("h_lo", "h_hi", "pos", "total"), out)))
shutdown()
"""


def _codes(k, nb, block, seed):
    """4 shards x nb halo'd blocks of one genome (~3 % N runs); shard 2's
    rows all invalid."""
    rng = np.random.default_rng(seed)
    K = 2 * k
    n = 4 * nb * block
    codes = rng.integers(0, 4, size=n).astype(np.int8)
    for st in rng.integers(0, n - 50, size=n // 1000):
        codes[st: st + int(rng.integers(1, 40))] = -1
    halo = K - 1
    flat = np.concatenate([np.full(halo, -1, np.int8), codes])
    rows = np.stack([flat[b * block: b * block + block + halo]
                     for b in range(4 * nb)])
    rows[2 * nb: 3 * nb] = -1
    return rows


@pytest.mark.parametrize("cfg", list(CASES), ids=["k8s4l1", "k12s6l3"])
def test_sharded_sketch_step_matches_jax(tmp_path, cfg):
    nb, block, cap = CASES[cfg]
    np.save(tmp_path / "codes.npy", _codes(cfg[0], nb, block, seed=cfg[0]))
    spec = json.dumps([cfg, CASES[cfg], str(tmp_path)])
    run_in_cpu_mesh(f"import sys; sys.path.insert(0, {REPO!r}); "
                    f"sys.argv = ['-', {spec!r}]\n" + _JAX, n_devices=4)
    run_ranks(["-c", _PORT, spec], 4, str(tmp_path / "logs"))
    want = np.load(tmp_path / "jax.npz")
    total = want["total"]
    assert total.shape == (4,) and total[2] == 0
    if cfg == (8, 4, 1):
        assert (total[[0, 1, 3]] > cap).all()  # the cap cuts
    else:
        assert 0 < total.max() < cap  # slots past total compared
    for r in range(4):
        got = np.load(tmp_path / f"rank{r}.npz")
        for name in ("h_lo", "h_hi", "pos", "total"):
            assert got[name].dtype == want[name].dtype, (r, name)
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"rank {r} {name}")
    if cfg == (12, 6, 3):
        assert want["h_hi"].any()  # a hash above 32 bits
