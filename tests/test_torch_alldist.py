"""Port counting and alldist (rabbitkssd_tpu_torch.ops.distance,
engine.dist_engine, cli) vs the JAX package and the golden outputs.

Exact comparison (tolerance 0): counts are integers and rows are text.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from rabbitkssd_tpu.cli import main as jax_main
from rabbitkssd_tpu.formats import read_sketches
from rabbitkssd_tpu.ops.distance import common_counts as jax_common_counts
from rabbitkssd_tpu.shuffle import generate_shuffle, write_shuffle_file
from rabbitkssd_tpu_torch.cli import main as port_main
from rabbitkssd_tpu_torch.ops.distance import common_counts

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _hash_sets(rng, n, hi, size, dtype):
    return [np.unique(rng.integers(0, hi, size=int(rng.integers(0, size)))
                      .astype(dtype)) for _ in range(n)]


@pytest.mark.parametrize("chunk", [None, 64])
def test_common_counts_device_path_symmetric(monkeypatch, chunk):
    """KSSD_HOST_JOIN_MAX=0 forces the int8 membership matmul on the CPU
    device; ``chunk`` forces several vocabulary chunks."""
    monkeypatch.setenv("KSSD_HOST_JOIN_MAX", "0")
    rng = np.random.default_rng(21)
    hashes = _hash_sets(rng, 23, 5000, 800, np.uint32)
    got = common_counts(hashes, None, "cpu", chunk=chunk)
    want = jax_common_counts(hashes, None)
    np.testing.assert_array_equal(got, want)
    assert got[0, 1] == np.intersect1d(hashes[0], hashes[1]).size


def test_device_path_holds_one_chunk_of_memberships(monkeypatch):
    """Each vocabulary chunk's two int8 memberships are freed before the
    next chunk's are built, so the device holds at most the one pair
    that ``membership_budget`` sized (BASELINE config 5's forced
    ``_int_mm`` leg held two, 32e9 bytes on an H100 80GB for a 19.8e9
    budget)."""
    import weakref

    from rabbitkssd_tpu_torch.ops import distance

    monkeypatch.setenv("KSSD_HOST_JOIN_MAX", "0")
    live = []
    alive_at_build = []
    build = distance._membership

    def tracked(*args):
        alive_at_build.append(sum(r() is not None for r in live))
        m = build(*args)
        live.append(weakref.ref(m))
        return m

    monkeypatch.setattr(distance, "_membership", tracked)
    rng = np.random.default_rng(23)
    ref = _hash_sets(rng, 9, 3000, 500, np.uint32)
    qry = _hash_sets(rng, 5, 3000, 300, np.uint32)
    got = common_counts(qry, ref, "cpu", chunk=64)
    np.testing.assert_array_equal(got, jax_common_counts(qry, ref))
    assert len(alive_at_build) >= 8  # several chunks, two builds each
    # the second side's build sees only this chunk's first side
    assert max(alive_at_build) == 1


@pytest.mark.parametrize("host_join_max", ["0", str(1 << 22)])
def test_common_counts_refquery(monkeypatch, host_join_max):
    """Ref/query counts, device path and host walk, 64-bit hashes."""
    monkeypatch.setenv("KSSD_HOST_JOIN_MAX", host_join_max)
    rng = np.random.default_rng(22)
    ref = _hash_sets(rng, 9, 3000, 500, np.uint64)
    qry = _hash_sets(rng, 5, 3000, 200, np.uint64)
    got = common_counts(qry, ref, "cpu")
    np.testing.assert_array_equal(got, jax_common_counts(qry, ref))


def _sorted_rows(path):
    with open(path) as f:
        lines = f.readlines()
    return lines[0], sorted(lines[1:])


@pytest.fixture
def golden_dir(tmp_path):
    """The golden genomes and list; the 1 GiB dense index a 32-bit
    sketch writes is deleted when the test ends."""
    shutil.copytree(os.path.join(GOLDEN, "genomes"), tmp_path / "genomes")
    shutil.copy(os.path.join(GOLDEN, "fa.list"), tmp_path)
    yield tmp_path
    for path in tmp_path.glob("*.index"):
        path.unlink()


@pytest.mark.parametrize("k,max_dist,outputs", [
    (5, "1.0", [("alldist", [])]),
    (8, "1.0", [("alldist", []), ("allcont", ["-M", "1"])]),
    (10, "0.5", [("alldist", [])]),
])
def test_cli_goldens(golden_dir, monkeypatch, k, max_dist, outputs):
    """Port CLI sketch + alldist == the reference binary's rows."""
    monkeypatch.chdir(golden_dir)
    stem = f"fa_k{k}s4l1"
    assert port_main(["--device", "cpu", "sketch", "-i", "fa.list", "-o",
                      f"{stem}.sketch", "-L",
                      os.path.join(GOLDEN, f"k{k}s4l1.shuf")]) == 0
    for kind, extra in outputs:
        out = f"{stem}.{kind}"
        assert port_main(["--device", "cpu", "alldist", "-i",
                          f"{stem}.sketch", "-o", out, "-D", max_dist]
                         + extra) == 0
        assert _sorted_rows(out) == _sorted_rows(os.path.join(GOLDEN, out))


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """~150 short mutated genomes, their shuffle, and the JAX CLI's
    sketch and alldist of them."""
    root = tmp_path_factory.mktemp("synthetic")
    rng = np.random.default_rng(2024)
    bases = np.frombuffer(b"ACGT", np.uint8)
    anc = [rng.integers(0, 4, size=6000) for _ in range(5)]
    files = []
    for g in range(150):
        seq = anc[g % 5][: 3000 + 17 * g].copy()
        pos = rng.integers(0, seq.size, size=int(seq.size * 0.02 * (g % 7)))
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=pos.size)) % 4
        txt = bases[seq]
        txt[int(rng.integers(0, 2000)):][:int(rng.integers(1, 20))] = ord("N")
        path = root / f"s{g:03d}.fa"
        path.write_bytes(b">s\n" + txt.tobytes() + b"\n")
        files.append(str(path))
    (root / "syn.list").write_text("\n".join(files) + "\n")
    shuf = str(root / "k10s4l1.shuf")
    write_shuffle_file(generate_shuffle(10, 4, 1), shuf)
    jdir = root / "jax"
    jdir.mkdir()
    mp = pytest.MonkeyPatch()
    mp.setenv("KSSD_DIST_BLOCK", "128")
    try:
        assert jax_main(["sketch", "-i", str(root / "syn.list"), "-o",
                         str(jdir / "syn.sketch"), "-L", shuf]) == 0
        assert jax_main(["alldist", "-i", str(jdir / "syn.sketch"), "-o",
                         str(jdir / "syn.alldist"), "-D", "1.0"]) == 0
    finally:
        mp.undo()
    return root, shuf, jdir


@pytest.mark.parametrize("strip_mode,dist_path", [
    ("dense", "auto"), ("dense", "matmul"), ("sparse", "auto")])
def test_cli_matches_jax_blocked(synthetic, tmp_path, monkeypatch,
                                 strip_mode, dist_path):
    """Two genome strips (KSSD_DIST_BLOCK=128 < 150): dense strips by
    walk or device matmul, and sparse strips, all equal the JAX CLI."""
    root, shuf, jdir = synthetic
    monkeypatch.setenv("KSSD_DIST_BLOCK", "128")
    monkeypatch.setenv("KSSD_STRIP_MODE", strip_mode)
    monkeypatch.setenv("KSSD_DIST_PATH", dist_path)
    if dist_path == "matmul":
        monkeypatch.setenv("KSSD_HOST_JOIN_MAX", "0")
    sk = str(tmp_path / "syn.sketch")
    assert port_main(["--device", "cpu", "sketch", "-i",
                      str(root / "syn.list"), "-o", sk, "-L", shuf]) == 0
    got = {s.name: s.hashes for s in read_sketches(sk).sketches}
    want = {s.name: s.hashes for s in
            read_sketches(str(jdir / "syn.sketch")).sketches}
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])
    out = str(tmp_path / "syn.alldist")
    assert port_main(["--device", "cpu", "alldist", "-i", sk, "-o", out,
                      "-D", "1.0"]) == 0
    with open(out) as a, open(jdir / "syn.alldist") as b:
        rows = a.read()
        assert rows == b.read()
    assert rows.count("\n") > 150
