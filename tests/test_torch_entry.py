"""The port's entry points (``rabbitkssd_tpu_torch.entry``) on the CPU.

* ``entry(device="cpu")``: the arguments equal the JAX ``entry()``'s
  (same shapes and seeds), two calls give equal results (the port keeps
  no state across calls, as the JAX step's donated buffers make it),
  and count, overflow and the carry buffers' survivors ``[:count]``
  (hashes, positions, batch ids) equal the JAX step's outputs on the
  same arguments;
* ``dryrun_multichip(4, device="cpu")``: 4 gloo CPU ranks run the
  sharded sketch step and the sharded count with the JAX dry run's
  checks.

Exact comparisons (tolerance 0): everything compared is an integer.
"""

import os
import sys

import numpy as np
import torch

from rabbitkssd_tpu_torch.entry import dryrun_multichip, entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_entry():
    sys.path.insert(0, REPO)
    import __graft_entry__

    return __graft_entry__.entry()


def test_entry_matches_jax_and_repeats():
    fn, args = entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args[:2])
    jfn, jargs = _jax_entry()
    # the same inputs: word rows, exception list, table, valid_upto
    np.testing.assert_array_equal(args[0].numpy().view(np.uint32), jargs[0])
    np.testing.assert_array_equal(args[1].numpy(), jargs[1])
    # the table: the JAX table's ranks at its kept dims, -1 elsewhere
    table, (jtable, jkept) = args[2].table.numpy(), jargs[2]
    kept = np.asarray(jkept)[np.asarray(jkept) >= 0]
    np.testing.assert_array_equal(table[kept], np.asarray(jtable)[kept])
    assert (np.delete(table, kept) == -1).all()
    assert (args[9], args[10]) == (int(jargs[9]), int(jargs[10]))

    first = fn(*args)
    second = fn(*args)
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert not args[3].any()  # the caller's buffers are left as they were

    want = [np.asarray(x) for x in jfn(*jargs)]
    count, overflow = int(first[4]), bool(first[5])
    assert (count, overflow) == (int(want[4]), bool(want[5]))
    assert count > 0 and not overflow
    for got, w, name in zip(first[:4], want[:4],
                            ("lo", "hi", "pos", "batch")):
        np.testing.assert_array_equal(
            got[:count].numpy().view(np.uint32), w[:count].view(np.uint32),
            err_msg=name)


def test_dryrun_multichip_4_cpu_ranks():
    reports = dryrun_multichip(4, device="cpu", timeout=120)
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    assert all(r["mesh"] == [2, 2] and r["device"] == "cpu"
               and not r["nccl"] for r in reports)
    # every rank holds every shard's total
    assert all(r["totals"] == reports[0]["totals"] for r in reports)
    assert len(reports[0]["totals"]) == 4
