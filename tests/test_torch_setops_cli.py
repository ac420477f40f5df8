"""The port's host-only commands against the reference binary's goldens.

The cases of tests/test_setops_cli.py (union, sub, merge, convert from
``kssd_dir/`` and the reverse round trip, ``info``, the 64-bit union)
through the port's CLI with ``--device cpu``, compared with
tests/golden/: byte-equal where the reference's output is canonical
(union, merge), as per-genome sets where its hash order is not (sub,
convert), and ``info`` (with ``-F`` and without) by its header, its
name/size lines and each genome's hash set.  The goldens are read with
the JAX package's readers, so the port's readers are not their own
referee.
"""

import os

import numpy as np
import pytest

from rabbitkssd_tpu.formats import read_kssd_dir, read_sketches
from rabbitkssd_tpu_torch.cli import main

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def cli(*argv: str) -> None:
    assert main(["--device", "cpu", *argv]) == 0


def _sets(path):
    sk = read_sketches(path)
    return {s.name: np.sort(s.hashes) for s in sk.sketches}, sk.info


def _assert_same_sets(got_path, want_path):
    got, ginfo = _sets(got_path)
    want, winfo = _sets(want_path)
    assert ginfo.id == winfo.id
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _same_bytes(a, b) -> bool:
    with open(a, "rb") as x, open(b, "rb") as y:
        return x.read() == y.read()


@pytest.mark.parametrize("sketch", ["fa_k8s4l1", "fa_k10s4l1"])
def test_union_byte_equal(tmp_path, monkeypatch, sketch):
    """The reference enumerates its bitmap in ascending hash order, the
    canonical sorted form: 32-bit and 64-bit hashes."""
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "u.sketch")
    cli("union", "-i", f"{sketch}.sketch", "-o", out)
    assert _same_bytes(out, f"{sketch}.union.sketch")


def test_sub_golden(tmp_path, monkeypatch):
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "s.sketch")
    cli("sub", "--rs", "fa_k8s4l1.union.sketch", "--qs", "faq_k8s4l1.sketch",
        "-o", out)
    _assert_same_sets(out, "fa_k8s4l1.sub.sketch")


def test_merge_byte_equal(tmp_path, monkeypatch):
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "m.sketch")
    lst = tmp_path / "merge.list"
    lst.write_text("fa_k8s4l1.sketch\nfaq_k8s4l1.sketch\n")
    cli("merge", "-i", str(lst), "-o", out)
    assert _same_bytes(out, "fa_k8s4l1.merged.sketch")


def test_convert_from_kssd(tmp_path, monkeypatch):
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "conv.sketch")
    cli("convert", "-i", "kssd_dir", "-o", out, "-q")
    _assert_same_sets(out, "fa_roundtrip.sketch")


def test_convert_reverse_roundtrip(tmp_path, monkeypatch):
    """sketch -> Kssd directory reads back set-equal under the
    reference reader's invariants (the JAX ``read_kssd_dir``)."""
    monkeypatch.chdir(GOLDEN)
    outdir = str(tmp_path / "kssd_out")
    cli("convert", "-i", "fa_k8s4l1.sketch", "-o", outdir, "--reverse")
    rt = read_kssd_dir(outdir)
    want, winfo = _sets("fa_k8s4l1.sketch")
    assert rt.info.id == winfo.id
    assert sorted(s.name for s in rt.sketches) == sorted(want)
    for s in rt.sketches:
        np.testing.assert_array_equal(np.sort(s.hashes), want[s.name])


def _parse_info(path):
    """(header, {name: (size, sorted hashes)}) of an ``info`` file; the
    hashes are empty without ``-F``."""
    with open(path) as f:
        lines = f.read().split("\n")
    entries = {}
    i = 1
    while i < len(lines) and lines[i]:
        name, size = lines[i].rsplit("\t", 1)
        vals = []
        i += 1
        while (i < len(lines) and "\t" in lines[i]
               and not lines[i][0].isalpha() and len(vals) < int(size)):
            vals.extend(int(v) for v in lines[i].split("\t") if v)
            i += 1
        if i < len(lines) and lines[i] == "":  # the blank line after a dump
            i += 1
        entries[name] = (int(size), sorted(vals))
    return lines[0], entries


@pytest.mark.parametrize("fined", [True, False], ids=["F", "plain"])
@pytest.mark.parametrize("sketch", ["fa_k8s4l1", "fa_k10s4l1", "fq_k8s4l1"])
def test_info_golden(tmp_path, monkeypatch, sketch, fined):
    """Header and name/size lines equal the reference's; with ``-F`` each
    genome's dumped hashes equal its as a set (the order is undefined),
    and without it no hash is written."""
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "o.info")
    cli("info", "-i", f"{sketch}.sketch", "-o", out, *(["-F"] if fined
                                                        else []))
    gh, got = _parse_info(out)
    wh, want = _parse_info(f"{sketch}.info")
    assert gh == wh
    assert got.keys() == want.keys()
    for k in got:
        assert got[k][0] == want[k][0], k
        assert got[k][1] == (want[k][1] if fined else []), k
    if not fined:
        with open(out) as f:
            assert len(f.read().strip("\n").split("\n")) == 1 + len(want)

