"""The kept set of a shuffle file (``shuffle.py:read_shuffle_kept``) and
the keep tables built from it (``ops/member.py:keep_tables``).

The native pass (``native/src/shuffle_kept.cpp``) and its NumPy twin
are held to ``bitmap_np((t >= 0) & (t < dim_end))`` and
``np.flatnonzero`` over ``read_shuffle_file``'s table; the tables from
the file to those from the in-memory table.  The ``cuda`` case sketches
from the file-built tables on the card
(``python -m pytest tests/test_torch_shuffle_kept.py -m cuda``).
Nothing here imports JAX.  Exact comparisons: everything is an integer.
"""

import json
import os

import numpy as np
import pytest
import torch

from rabbitkssd_tpu_torch import native
from rabbitkssd_tpu_torch.engine.sketcher import sketch_file_list
from rabbitkssd_tpu_torch.ops.member import keep_tables, summary_np
from rabbitkssd_tpu_torch.oracle import sketch_records_oracle
from rabbitkssd_tpu_torch.params import KssdParams
from rabbitkssd_tpu_torch.seqio import read_list, read_records
from rabbitkssd_tpu_torch.shuffle import (KEPT_RANGE, ShuffleFile,
                                          bitmap_np, read_shuffle_file,
                                          read_shuffle_kept,
                                          write_shuffle_file)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# (half_k, half_subk, drlevel) a subk, and a range of entries that does
# not divide its table (16^subk is a power of two, 32 * 7^j is not)
CONFIGS = {3: ((8, 3, 0), 32 * 7), 4: ((8, 4, 1), 32 * 7 * 3),
           5: ((8, 5, 2), 32 * 7 ** 3), 6: ((10, 6, 3), 32 * 7 ** 4)}


def _table(subk: int, kind: str) -> np.ndarray:
    """A permutation, or a table that is none: negatives (int32's least
    among them), values at and past dim_end, repeats."""
    (k, s, l), _ = CONFIGS[subk]
    n, dim_end = 1 << (4 * s), KssdParams(k, s, l).dim_end
    rng = np.random.default_rng(subk)
    if kind == "perm":
        return rng.permutation(n).astype(np.int32)
    t = rng.integers(-dim_end, 3 * dim_end, size=n).astype(np.int32)
    t[rng.integers(0, n, size=64)] = np.iinfo(np.int32).min
    t[rng.integers(0, n, size=64)] = np.iinfo(np.int32).max
    t[: 40] = dim_end - 1  # repeats, and a kept run across a word
    return t


@pytest.fixture(scope="module")
def shuf_files(tmp_path_factory):
    """(subk, kind) -> path of a .shuf file, written once."""
    d = tmp_path_factory.mktemp("shuf")
    out = {}
    for subk, ((k, s, l), _) in CONFIGS.items():
        for kind in ("perm", "mixed"):
            path = str(d / f"s{subk}_{kind}.shuf")
            write_shuffle_file(ShuffleFile(7, k, s, l, _table(subk, kind)),
                               path)
            out[subk, kind] = path
    return out


def _want(path: str):
    """(bitmap, dims, values) of read_shuffle_file's table."""
    sf = read_shuffle_file(path)
    t = sf.shuffled_dim
    mask = (t >= 0) & (t < KssdParams(sf.k, sf.subk, sf.drlevel).dim_end)
    dims = np.flatnonzero(mask)
    return bitmap_np(mask), dims, t[dims]


def _assert_kept(got, want, dim_size):
    bm, dims, vals = want
    assert got.dim_size == dim_size
    assert got.bitmap.dtype == got.dims.dtype == got.values.dtype == np.int32
    np.testing.assert_array_equal(got.bitmap, bm)
    np.testing.assert_array_equal(got.dims, dims)
    np.testing.assert_array_equal(got.values, vals)


def _no_native(monkeypatch):
    monkeypatch.setattr(native, "shuffle_kept", lambda *a: None)


@pytest.mark.parametrize("whole", [True, False],
                         ids=["one range", "ranges not dividing"])
@pytest.mark.parametrize("threads", [1, 2, 5])
@pytest.mark.parametrize("kind", ["perm", "mixed"])
@pytest.mark.parametrize("subk", sorted(CONFIGS))
def test_native_pass_matches_the_table(shuf_files, subk, kind, threads,
                                       whole):
    if native.load_native() is None:
        pytest.skip("no native toolchain")
    path = shuf_files[subk, kind]
    rng = KEPT_RANGE if whole else CONFIGS[subk][1]
    got = read_shuffle_kept(path, threads, rng)
    (k, s, l), _ = CONFIGS[subk]
    assert (got.id, got.k, got.subk, got.drlevel) == (7, k, s, l)
    assert got.kept.threads == threads
    assert got.kept.dim_end == KssdParams(k, s, l).dim_end
    _assert_kept(got.kept, _want(path), 1 << (4 * s))


@pytest.mark.parametrize("whole", [True, False],
                         ids=["one range", "ranges not dividing"])
@pytest.mark.parametrize("kind", ["perm", "mixed"])
@pytest.mark.parametrize("subk", sorted(CONFIGS))
def test_numpy_twin_matches_the_table(shuf_files, monkeypatch, subk, kind,
                                      whole):
    _no_native(monkeypatch)
    path = shuf_files[subk, kind]
    got = read_shuffle_kept(path, 4,
                            KEPT_RANGE if whole else CONFIGS[subk][1])
    assert got.kept.threads == 0
    _assert_kept(got.kept, _want(path), 1 << (4 * subk))


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("cut", ["header", "table start", "table middle",
                                 "last entry"])
def test_truncated_file_raises_as_the_reader(shuf_files, tmp_path,
                                             monkeypatch, impl, cut):
    """A truncated header or table: the IOError of read_shuffle_file,
    whatever the range the cut falls in."""
    if impl == "numpy":
        _no_native(monkeypatch)
    elif native.load_native() is None:
        pytest.skip("no native toolchain")
    with open(shuf_files[4, "perm"], "rb") as f:
        data = f.read()
    at = {"header": 10, "table start": 16, "table middle": len(data) // 2,
          "last entry": len(data) - 4}[cut]
    path = str(tmp_path / "cut.shuf")
    with open(path, "wb") as f:
        f.write(data[:at])
    with pytest.raises(IOError) as want:
        read_shuffle_file(path)
    for threads in (1, 5):
        with pytest.raises(IOError) as got:
            read_shuffle_kept(path, threads, 32 * 7)
        assert str(got.value) == str(want.value)
        assert type(got.value) is type(want.value)


@pytest.mark.parametrize("kind", ["perm", "mixed"])
@pytest.mark.parametrize("subk", [3, 5])
def test_tables_from_the_file_equal_the_in_memory_ones(shuf_files, subk,
                                                       kind):
    """Bitmap, summary, shift and the table at kept dims as keep_tables
    of the whole permutation; -1 elsewhere; one copy of the bitmap, the
    summary and the kept pairs."""
    path = shuf_files[subk, kind]
    (k, s, l), _ = CONFIGS[subk]
    dim_end = KssdParams(k, s, l).dim_end
    kept = read_shuffle_kept(path, 2).kept
    got = keep_tables(kept, dim_end, "cpu")
    t = read_shuffle_file(path).shuffled_dim
    want = keep_tables(t, dim_end, "cpu")
    for a, b in ((got.bitmap, want.bitmap), (got.summary, want.summary),
                 (got.table, want.table)):
        assert torch.equal(a, b)
    assert (got.shift, got.dim_size) == (want.shift, want.dim_size)
    mask = (t >= 0) & (t < dim_end)
    table = got.table.numpy()
    np.testing.assert_array_equal(table[mask], t[mask])
    assert (table[~mask] == -1).all()
    summary, _ = summary_np(kept.bitmap, kept.dim_size)
    n = int(mask.sum())
    assert got.bytes_up == 4 * (-(-kept.bitmap.size // 4) * 4
                                + summary.size + 2 * n)
    assert (got.threads, want.threads) == (kept.threads, 0)


def test_tables_refuse_a_kept_set_of_another_dim_end(shuf_files):
    kept = read_shuffle_kept(shuf_files[4, "perm"], 1).kept
    with pytest.raises(ValueError, match="dim_end"):
        keep_tables(kept, kept.dim_end * 16, "cpu")


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
@pytest.mark.parametrize("shuf", ["k8s4l1.shuf", "L3K10"])
def test_sketch_from_the_file_equals_the_oracle(tmp_path, monkeypatch,
                                                capsys, device, shuf):
    """The golden genomes sketched from the file's kept set: equal to the
    numpy oracle over the whole table and to the CPU path from the
    in-memory table; the budget reports the copy and the pass."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream kernels have no CPU "
                    "mode")
    if shuf == "L3K10":
        path = str(tmp_path / "l3k10.shuf")
        t = np.random.default_rng(5).permutation(1 << 24).astype(np.int32)
        write_shuffle_file(ShuffleFile((10 << 8) + (6 << 4) + 3, 10, 6, 3,
                                       t), path)
    else:
        path = os.path.join(GOLDEN, shuf)
    monkeypatch.chdir(GOLDEN)
    sf = read_shuffle_file(path)
    params = KssdParams(sf.k, sf.subk, sf.drlevel)
    kept = read_shuffle_kept(path, 3)
    capsys.readouterr()
    got = sketch_file_list("fa.list", kept, device=device)
    (line,) = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("sketch budget: ")]
    budget = json.loads(line[len("sketch budget: "):])
    summary, _ = summary_np(kept.kept.bitmap, params.dim_size)
    assert budget["keep_threads"] == kept.kept.threads
    assert budget["keep_bytes_up"] == 4 * (
        -(-kept.kept.bitmap.size // 4) * 4 + summary.size
        + 2 * kept.kept.dims.size)
    plain = sketch_file_list("fa.list", sf, device="cpu")
    files = read_list("fa.list")
    assert [s.name for s in got.sketches] == [s.name for s in plain.sketches]
    for g, p in zip(got.sketches, plain.sketches):
        want = sketch_records_oracle(
            [(r.seq, r.qual) for r in read_records(g.name)], params,
            sf.shuffled_dim)
        np.testing.assert_array_equal(g.hashes, want, err_msg=g.name)
        np.testing.assert_array_equal(p.hashes, want, err_msg=g.name)
    assert sorted(s.name for s in got.sketches) == sorted(files)
