"""The port's CLI in several gloo CPU ranks against the JAX CLI in one
process: the tests/multihost_cli_child.py chain (sketch, alldist -D 1.0,
dist, dist -N 2, union, sub, merge, info -F) on the
tests/test_multihost.py corpus.

Every rank computes the replicated result; only local rank 0 of each
node writes, into the node's output directory.  Every file there must
be byte-equal to the JAX CLI's, and the other ranks must open no file
there for writing (an audit hook in each rank records such opens).
Counting is forced onto the mesh (``KSSD_HOST_JOIN_MAX=0``).
"""

import json
import os

import pytest

from rabbitkssd_tpu.cli import main as jax_main
from test_multihost import _write_corpus
from torch_ranks import rank_results, run_ranks

CHAIN = [
    ["sketch", "-L", "{shuf}", "-i", "{list}", "-o", "corpus.sketch"],
    ["alldist", "-i", "corpus.sketch", "-L", "{shuf}", "-o", "corpus.alldist",
     "-D", "1.0"],
    ["dist", "-r", "ref.list", "-q", "qry.list", "-L", "{shuf}", "-o",
     "rq.dist", "-D", "1.0"],
    ["dist", "-r", "ref.list", "-q", "qry.list", "-L", "{shuf}", "-o",
     "rq_top2.dist", "-D", "1.0", "-N", "2"],
    ["union", "-i", "corpus.sketch", "-o", "u.sketch"],
    ["sub", "--rs", "u.sketch", "--qs", "corpus.sketch", "-o", "s.sketch"],
    ["merge", "-i", "merge.list", "-o", "m.sketch"],
    ["info", "-i", "m.sketch", "-o", "m.info", "-F"],
]

_CHILD = r"""
import json, os, sys
from rabbitkssd_tpu_torch.cli import main
from rabbitkssd_tpu_torch.parallel.multihost import shutdown

chain = json.loads(sys.argv[1])
here = os.getcwd()
wrote = []


def audit(event, args):
    # file writes into this node's directory
    if event == "open":
        path, mode, flags = args
        if mode is None:
            w = bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
        else:
            w = any(c in mode for c in "wax+")
        paths = [path] if w else []
    elif event in ("os.rename", "shutil.move"):  # os.replace included
        paths = args[:2]
    elif event == "shutil.copyfile":
        paths = args[1:2]
    elif event in ("os.remove", "os.rmdir", "os.mkdir", "os.truncate"):
        paths = args[:1]
    else:
        return
    for path in paths:
        if isinstance(path, int):
            continue
        path = os.path.abspath(os.fsdecode(path))
        if path.startswith(here + os.sep):
            wrote.append(os.path.relpath(path, here))


sys.addaudithook(audit)
for argv in chain:
    assert main(["--device", "cpu"] + argv) == 0, argv
print("WROTE", json.dumps(wrote))
shutdown()
"""


def _prepare(root: str, list_path: str) -> None:
    """The dist and merge legs' list files, as multihost_cli_child.py
    writes them."""
    os.makedirs(root)
    with open(list_path) as f:
        files = [ln for ln in f.read().splitlines() if ln]
    for name, lines in (("ref.list", files[:4]), ("qry.list", files[4:]),
                        ("merge.list", ["corpus.sketch", "u.sketch"])):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def _files(root: str) -> dict:
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("world,local", [(3, 3), (4, 2)],
                         ids=["1node_3ranks", "2nodes_2ranks"])
def test_cli_chain_ranks_equal_jax(tmp_path, monkeypatch, world, local):
    """3 ranks on one node (mesh (1, 3)), or 2 nodes of 2 ranks (mesh
    (2, 2): the ring across nodes, the reduction within each)."""
    list_path, shuf_path = _write_corpus(str(tmp_path / "corpus"))
    chain = [[a.format(shuf=shuf_path, list=list_path) for a in argv]
             for argv in CHAIN]

    ref = str(tmp_path / "jax")
    _prepare(ref, list_path)
    monkeypatch.chdir(ref)
    for argv in chain:
        assert jax_main(argv) == 0, argv
    want = _files(ref)

    nodes = [str(tmp_path / f"node{i}") for i in range(world // local)]
    for d in nodes:
        _prepare(d, list_path)
    outs = run_ranks(["-c", _CHILD, json.dumps(chain)], world,
                     str(tmp_path / "logs"), local=local, cwds=nodes,
                     env={"KSSD_HOST_JOIN_MAX": "0"})
    outputs = {"corpus.sketch", "corpus.alldist", "rq.dist", "rq_top2.dist",
               "u.sketch", "s.sketch", "m.sketch", "m.info"}
    for r, out in enumerate(outs):
        wrote = json.loads(out.split("WROTE", 1)[1])
        if r % local:
            assert wrote == [], f"rank {r} wrote {wrote}"
        else:
            assert outputs <= set(wrote), f"rank {r} wrote {wrote}"
    for d in nodes:
        got = _files(d)
        assert sorted(got) == sorted(want)
        for name, data in want.items():
            assert got[name] == data, f"{d}: {name} differs from the JAX CLI"


_DIES_CHILD = r"""
import json, sys
from rabbitkssd_tpu_torch.cli import main
from rabbitkssd_tpu_torch.parallel.multihost import init_multihost, rank

assert init_multihost()
if rank() == 1:
    sys.exit(3)  # this rank dies before the command
sys.exit(main(["--device", "cpu"] + json.loads(sys.argv[1])))
"""


def test_dead_rank_fails_every_rank(tmp_path):
    """A rank that dies fails the others' next collective (here the
    sketch's first flush): every rank exits non-zero, none hangs."""
    list_path, shuf_path = _write_corpus(str(tmp_path / "corpus"))
    argv = CHAIN[0][:]
    argv = [a.format(shuf=shuf_path, list=list_path) for a in argv]
    res = rank_results(["-c", _DIES_CHILD, json.dumps(argv)], 3,
                       str(tmp_path / "logs"), cwds=[str(tmp_path)],
                       timeout=60)
    assert [rc for rc, _, _ in res][1] == 3
    for r in (0, 2):
        rc, _, err = res[r]
        assert rc != 0, f"rank {r} carried on alone"
        assert "Traceback" in err, err[-2000:]
    assert not os.path.exists(tmp_path / "corpus.sketch")
