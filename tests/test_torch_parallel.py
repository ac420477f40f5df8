"""The port's multi-rank runtime and sharded counting
(rabbitkssd_tpu_torch.parallel) against the JAX package.

Multi-rank cases start gloo CPU ranks (tests/torch_ranks.py) and hold
every rank's counts against the JAX ``common_counts`` run here on the
same seeded hashes and against ``np.intersect1d`` counts: exact
equality (tolerance 0; the counts are integers).  The ring runs at
dp = 3, where passing shards the wrong way round the ring lands them on
the wrong columns.
"""

import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from rabbitkssd_tpu.ops.distance import common_counts as jax_common_counts
from rabbitkssd_tpu.parallel.multihost import global_mesh as jax_global_mesh
from rabbitkssd_tpu.parallel.sharded import make_mesh as jax_make_mesh
from rabbitkssd_tpu_torch.device import resolve_device
from rabbitkssd_tpu_torch.ops.distance import common_counts
from rabbitkssd_tpu_torch.parallel import multihost
from rabbitkssd_tpu_torch.parallel.sharded import (Mesh, make_mesh,
                                                   sharded_common_counts,
                                                   split_pairs)
from torch_ranks import run_ranks


def _hashes():
    """The tests/test_parallel.py ring recipe: 11 genomes (not divisible
    by dp 2 or 3), several thousand shared hashes."""
    rng = np.random.default_rng(17)
    return [np.unique(rng.integers(0, 30000, rng.integers(50, 1200))
                      .astype(np.uint64)) for _ in range(11)]


def _oracle(a, b):
    return np.array([[np.intersect1d(x, y).size for y in b] for x in a],
                    np.int32)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_rules_match_jax(n):
    """make_mesh on one node and global_mesh across nodes give the JAX
    package's (dp, vp) for n ranks (JAX: n devices, ``local`` per
    process)."""
    dev = jax.devices()[0]
    want = jax_make_mesh(devices=[dev] * n).devices.shape
    got = make_mesh(n, n)
    assert (got.dp, got.vp) == want
    for local in [d for d in range(1, n + 1) if n % d == 0]:
        with mock.patch.object(jax, "devices", lambda: [dev] * n), \
                mock.patch.object(jax, "local_device_count", lambda: local):
            want = jax_global_mesh().devices.shape
        got = multihost.global_mesh(n, local)
        assert (got.dp, got.vp) == want, local
        if local < n:  # several nodes: make_mesh delegates
            assert make_mesh(n, local) == got


def test_single_process_runtime(monkeypatch):
    """Without the launcher's environment nothing starts: one rank,
    which writes, and a 1 x 1 mesh whose ring is the plain count."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.init_multihost() is False
    assert (multihost.rank(), multihost.world(), multihost.local_rank(),
            multihost.local_world()) == (0, 1, 0, 1)
    assert multihost.is_writer()
    multihost.barrier()
    assert make_mesh() == Mesh(1, 1)
    h = _hashes()
    with mock.patch.dict(os.environ, {"KSSD_HOST_JOIN_MAX": "0"}):
        got = sharded_common_counts(h, None, Mesh(1, 1), "cpu", chunk=64)
    np.testing.assert_array_equal(got, common_counts(h, None, "cpu"))
    with pytest.raises(ValueError, match="3 shards"):
        sharded_common_counts(h, None, Mesh(3, 1), "cpu")


def test_split_pairs_buckets():
    """Each pair lands in its (genome shard, column slice) bucket, made
    local to both; pads carry the dropped column ``width``."""
    g = np.array([0, 4, 2, 5, 1, 3], np.int32)
    c = np.array([0, 1, 33, 40, 63, 63], np.int64)
    out = split_pairs(g, c, dp=2, vp=2, group=3, width=32)
    assert out.shape == (2, 2, 2, 2)
    assert out[0, 0].tolist() == [[0, 0], [0, 32]]
    assert out[0, 1].tolist() == [[2, 1], [1, 31]]
    assert out[1, 0].tolist() == [[1, 0], [1, 32]]
    assert out[1, 1].tolist() == [[2, 0], [8, 31]]


def test_resolve_device_local_rank(monkeypatch):
    """A multi-rank run puts each rank on cuda:LOCAL_RANK, never wrapped
    round the visible cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device("cuda") == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="visible"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="visible"):
        resolve_device("cuda:3")


@pytest.mark.parametrize("cmd", ["alldist", "dist"])
@pytest.mark.parametrize("blocked", [False, True])
def test_engine_without_output(tmp_path, monkeypatch, cmd, blocked):
    """A rank that does not write passes no output file: below one block
    it still counts (there the count is collective), a blocked run
    (rank-local counting) returns at once; neither writes a file."""
    from rabbitkssd_tpu.formats import Sketch, SketchInfo, SketchSet
    from rabbitkssd_tpu_torch.engine import dist_engine as de

    h = _hashes()
    sk = SketchSet(info=SketchInfo(id=1, half_k=10, half_subk=6, drlevel=3,
                                   genome_number=len(h)),
                   sketches=[Sketch(f"g{i}", x) for i, x in enumerate(h)])
    monkeypatch.setenv("KSSD_DIST_PATH", "matmul")  # count through _counts
    monkeypatch.setattr(de, "_auto_block", lambda n=0: 4 if blocked else n)
    calls = []
    monkeypatch.setattr(de, "_counts",
                        lambda *a: calls.append(a) or common_counts(*a))
    monkeypatch.setattr(de, "_write_rows", lambda *a: calls.append("write"))
    monkeypatch.chdir(tmp_path)
    if cmd == "alldist":
        de.run_alldist(sk, None, 1.0, False, "cpu")
    else:
        de.run_dist(sk, sk, None, 1.0, False, "cpu")
    assert len(calls) == (0 if blocked else 1)
    assert "write" not in calls and not os.listdir(tmp_path)


_COUNTS_CHILD = r"""
import os, sys
import numpy as np
from rabbitkssd_tpu_torch.parallel.multihost import (init_multihost, rank,
                                                     shutdown)
from rabbitkssd_tpu_torch.parallel.sharded import Mesh, sharded_common_counts

dp, vp, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert init_multihost()
mesh = Mesh(dp, vp)
z = np.load(os.path.join(work, "hashes.npz"))
h = [z[f"h{i}"] for i in range(len(z.files))]
q = h[:5]
out = {"host": sharded_common_counts(h, None, mesh, "cpu")}
os.environ["KSSD_HOST_JOIN_MAX"] = "0"  # the ring, not the host walk
out["sym"] = sharded_common_counts(h, None, mesh, "cpu")
out["sym_chunks"] = sharded_common_counts(h, None, mesh, "cpu", chunk=64)
out["rq_chunks"] = sharded_common_counts(q, h, mesh, "cpu", chunk=64)
out["qr"] = sharded_common_counts(h, q, mesh, "cpu")
np.savez(os.path.join(work, f"rank{rank()}.npz"), **out)
print("COORDS", *mesh.coords)
shutdown()
"""


@pytest.mark.parametrize("dp,vp", [(3, 1), (2, 2), (1, 3)])
def test_sharded_common_counts_ranks(tmp_path, dp, vp):
    """The ring (dp) and the reduction (vp) in gloo CPU ranks:
    all-vs-all and ref-vs-query, n0 = 11 and n1 = 5 not divisible by
    dp, many vocabulary chunks (chunk = 64 columns), and the host
    shortcut; every rank returns the same counts."""
    h = _hashes()
    np.savez(tmp_path / "hashes.npz", **{f"h{i}": x for i, x in enumerate(h)})
    q = h[:5]
    n = dp * vp
    outs = run_ranks(["-c", _COUNTS_CHILD, str(dp), str(vp), str(tmp_path)],
                     n, str(tmp_path / "logs"))
    coords = sorted(tuple(int(x) for x in o.split("COORDS")[1].split())
                    for o in outs)
    assert coords == [(d, v) for d in range(dp) for v in range(vp)]
    sym = jax_common_counts(h, None)
    np.testing.assert_array_equal(sym, _oracle(h, h))
    want = {"host": sym, "sym": sym, "sym_chunks": sym,
            "rq_chunks": jax_common_counts(q, h),
            "qr": jax_common_counts(h, q)}
    np.testing.assert_array_equal(want["rq_chunks"], _oracle(q, h))
    np.testing.assert_array_equal(want["qr"], _oracle(h, q))
    for r in range(n):
        got = np.load(tmp_path / f"rank{r}.npz")
        for k, v in want.items():
            assert got[k].dtype == np.int32, (r, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r} {k}")
