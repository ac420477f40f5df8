"""The port's sharded sketcher (``DeviceSketcher`` on the mesh of 3 gloo
CPU ranks) against the JAX package's sketch oracle
(``rabbitkssd_tpu.oracle``).

The corpus is tests/test_sharded_sketcher.py's: five sequences with N
runs at (8, 4, 1), and one 400 kb genome at (10, 6, 3) whose survivors
fall in every shard.  Exact comparison (tolerance 0): per-genome sorted
hash sets, on every rank.
"""

import json

import numpy as np
import pytest

from rabbitkssd_tpu.ops.kmer import encode_concat
from rabbitkssd_tpu.oracle import sketch_records_oracle
from rabbitkssd_tpu.params import KssdParams
from rabbitkssd_tpu.shuffle import generate_shuffle
from torch_ranks import run_ranks


def _corpus():
    rng = np.random.default_rng(9)
    seqs = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                             p=[.24, .24, .24, .24, .04], size=n))
            for n in (900, 150000, 37, 80000, 12345)]
    big = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400000))
    return seqs, big


# case -> (half_k, half_subk, drlevel, n_blocks, block, per-batch cap)
CASES = {"small": (8, 4, 1, 2, 4096, None),
         "sparse": (10, 6, 3, 1, 8192, None),
         "overflow": (8, 4, 1, 2, 4096, 64)}

_CHILD = r"""
import json, os, sys
import numpy as np
from rabbitkssd_tpu.params import KssdParams
from rabbitkssd_tpu.shuffle import generate_shuffle
from rabbitkssd_tpu_torch.engine.sketcher import DeviceSketcher, StreamStep
from rabbitkssd_tpu_torch.parallel.multihost import (init_multihost, rank,
                                                     shutdown)

k, s, l, nb, block, cap = json.loads(sys.argv[1])
work = sys.argv[2]
assert init_multihost()
z = np.load(os.path.join(work, "codes.npz"))
codes = [z[f"g{i}"] for i in range(len(z.files))]
params = KssdParams(k, s, l)
sk = DeviceSketcher(params, generate_shuffle(k, s, l).shuffled_dim, "cpu",
                    n_blocks=nb, block=block)
assert sk.mesh.size == 3
if cap is not None:
    sk.cap = cap
    sk.step = StreamStep(params, cap, sk.buf_cap)
got, n = sk.sketch_codes(iter(codes))
assert n == len(codes)
np.savez(os.path.join(work, f"rank{rank()}.npz"),
         **{f"g{i}": h for i, h in enumerate(got)})
print("BUDGET", json.dumps(sk.last_budget))
shutdown()
"""


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_sketcher_3_ranks(tmp_path, case):
    """Every rank returns the oracle's sets; batches and flushes pair up
    across ranks; a per-batch cap of 64 overflows every window, and the
    shard-local full-capacity re-runs keep the result exact."""
    k, s, l, nb, block, cap = CASES[case]
    seqs, big = _corpus()
    seqs = [big] if case == "sparse" else seqs
    codes = [encode_concat([(x, None)]) for x in seqs]
    np.savez(tmp_path / "codes.npz", **{f"g{i}": c for i, c in enumerate(codes)})
    outs = run_ranks(["-c", _CHILD, json.dumps(CASES[case]), str(tmp_path)],
                     3, str(tmp_path / "logs"))
    params = KssdParams(k, s, l)
    shuf = generate_shuffle(k, s, l)
    want = [sketch_records_oracle([(x, None)], params, shuf.shuffled_dim)
            for x in seqs]
    assert sum(w.size for w in want) > 64
    budgets = [json.loads(o.split("BUDGET", 1)[1]) for o in outs]
    for r, b in enumerate(budgets):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert len(got.files) == len(want)
        for i, w in enumerate(want):
            h = got[f"g{i}"]
            assert h.dtype == w.dtype, (r, i)
            np.testing.assert_array_equal(h, w, err_msg=f"rank {r} genome {i}")
        assert b["batches"] == budgets[0]["batches"] > 1
        assert "exchange" in b
        # each rank uploads its third of every batch's words
        assert b["h2d_bytes"] == budgets[0]["h2d_bytes"]
        # the roles' parts: fed codes, no parser waited on; staging in
        # an unpinned ring on the CPU; the consumer's CPU time over its
        # loop of dispatches and waits
        assert b["parse_wait"] == 0 <= b["feed"]
        assert 0 <= b["pin"] <= b["h2d_put"] and b["pinned_allocs"] == 0
        assert 0 <= b["consumer_cpu"] <= \
            1.05 * (b["dispatch"] + b["qwait"]) + 0.02
        if cap is not None:
            assert b["reruns"] == b["batches"]
        else:
            assert b["reruns"] == 0
