"""Reference ("oracle") sketchers: exact but slow/medium-speed CPU paths.

Two independent implementations of the reference hot loop
(reference sketch.cpp:491-532 fasta, 781-825 fastq):

* :func:`oracle_hashes_pyloop` — a direct per-base rolling-window
  transliteration in Python ints.  Ground truth for tiny inputs.
* :func:`oracle_hashes_numpy` — a vectorized numpy uint64 windowed
  formulation (different algorithm, same math).  Fast referee used to
  validate the device kernels on larger inputs, itself validated
  against the pyloop oracle.

The port's copy of ``rabbitkssd_tpu/oracle.py``.

Semantics replicated exactly:
  - 2-bit base codes via BaseMap (A/a=0, C/c=1, G/g=2, T/t=3, else invalid)
  - non-ACGT (and low-quality, for fastq) bases reset the window run
  - forward and reverse-complement rolling codes; canonical = min
  - dim_id = middle-context bits; keep iff shuffled rank in [dim_start,
    dim_end); hash = outer-context bits recomposed | rank
  - k-mers never span sequence-record boundaries
"""

from __future__ import annotations

import numpy as np

from .params import BASE_MAP, KssdParams

_BASE_LUT = np.full(256, -1, dtype=np.int8)
for _i, _v in enumerate(BASE_MAP):
    if _v >= 0:
        _BASE_LUT[_i] = _v


def encode_bases(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> int8 base codes (0..3, -1 for invalid)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _BASE_LUT[arr]


def oracle_hashes_pyloop(
    seq: bytes | str,
    params: KssdParams,
    shuffled_dim: np.ndarray,
    quality: bytes | None = None,
    least_qual: int = 0,
) -> list[int]:
    """Per-base rolling loop; returns every emitted hash (with duplicates)."""
    if isinstance(seq, str):
        seq = seq.encode()
    p = params
    tupmask = p.tupmask
    domask = p.domask
    undomask0 = p.undomask0
    undomask1 = p.undomask1
    rev_add_move = p.rev_add_move
    hoc2 = p.half_outctx_len * 2
    u1shift = p.undomask1_shift
    dr4 = p.drlevel * 4
    ksize = p.kmer_size

    tup = 0
    rvs = 0
    base = 1
    out: list[int] = []
    for i, ch in enumerate(seq):
        bn = BASE_MAP[ch] if ch < 128 else -1
        ok = bn != -1 and (quality is None or quality[i] >= least_qual)
        if ok:
            tup = ((tup << 2) | bn) & tupmask
            rvs = (rvs >> 2) + ((bn ^ 3) << rev_add_move)
            base += 1
        else:
            base = 1
        if base > ksize:
            uni = tup if tup < rvs else rvs
            dim_id = (uni & domask) >> hoc2
            pfilter = int(shuffled_dim[dim_id])
            if pfilter < p.dim_start or pfilter >= p.dim_end:
                continue
            pfilter -= p.dim_start
            dr = (((uni & undomask0) | ((uni & undomask1) << u1shift)) >> dr4) | pfilter
            out.append(dr)
    return out


def _win_all_valid(valid: np.ndarray, k: int) -> np.ndarray:
    """all-valid over trailing window of length k, at each position."""
    c = np.cumsum(valid.astype(np.int64))
    full = np.zeros(len(valid), dtype=bool)
    if len(valid) >= k:
        wsum = c[k - 1 :].copy()
        wsum[1:] -= c[: len(valid) - k]
        full[k - 1 :] = wsum == k
    return full


def oracle_hashes_numpy(
    seq: bytes | str,
    params: KssdParams,
    shuffled_dim: np.ndarray,
    quality: bytes | None = None,
    least_qual: int = 0,
) -> np.ndarray:
    """Vectorized windowed formulation; returns emitted hashes (uint64,
    with duplicates, in position order)."""
    p = params
    b = encode_bases(seq)
    valid = b >= 0
    if quality is not None:
        q = np.frombuffer(quality, dtype=np.uint8)
        valid &= q >= least_qual
    K = p.kmer_size
    n = len(b)
    if n < K:
        return np.empty(0, dtype=np.uint64)
    bu = np.where(valid, b, 0).astype(np.uint64)

    fwd = np.zeros(n, dtype=np.uint64)
    rvs = np.zeros(n, dtype=np.uint64)
    for t in range(K):
        # base at position i-t contributes to window ending at i
        shifted = np.empty(n, dtype=np.uint64)
        if t:
            shifted[:t] = 0
            shifted[t:] = bu[:-t]
        else:
            shifted = bu
        fwd |= shifted << np.uint64(2 * t)
        rvs |= (shifted ^ np.uint64(3)) << np.uint64(2 * (K - 1 - t))
    fwd &= np.uint64(p.tupmask)

    ok = _win_all_valid(valid, K)
    uni = np.minimum(fwd, rvs)
    dim_id = ((uni & np.uint64(p.domask)) >> np.uint64(2 * p.half_outctx_len)).astype(
        np.int64
    )
    pfilter = shuffled_dim[dim_id].astype(np.int64)
    keep = ok & (pfilter >= p.dim_start) & (pfilter < p.dim_end)
    pf = (pfilter - p.dim_start).astype(np.uint64)
    dr = (
        (
            (uni & np.uint64(p.undomask0))
            | ((uni & np.uint64(p.undomask1)) << np.uint64(p.undomask1_shift))
        )
        >> np.uint64(p.drlevel * 4)
    ) | pf
    return dr[keep]


def sketch_records_oracle(
    records: list[tuple[bytes, bytes | None]],
    params: KssdParams,
    shuffled_dim: np.ndarray,
    least_qual: int = 0,
    least_num_kmer: int = 1,
) -> np.ndarray:
    """Sketch one genome (list of (seq, quality-or-None) records) -> sorted
    unique hash array, honoring the fastq abundance threshold."""
    parts = [
        oracle_hashes_numpy(seq, params, shuffled_dim, qual, least_qual)
        for seq, qual in records
    ]
    allh = (
        np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)
    )
    if allh.size == 0:
        vals = allh
    elif least_num_kmer > 1:
        vals, counts = np.unique(allh, return_counts=True)
        vals = vals[counts >= least_num_kmer]
    else:
        vals = np.unique(allh)
    dt = np.uint64 if params.use64 else np.uint32
    return vals.astype(dt)
