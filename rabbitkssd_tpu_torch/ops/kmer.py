"""k-mer window hashing as torch ops (port of ``rabbitkssd_tpu/ops/kmer.py``).

Host part: the numpy helpers of the JAX module (copied, since it
imports jax).  Device part: :class:`StreamHasher`, the bitstream
formulation of ``hash_windows_stream`` that the sketch stream step
uses — each window's forward code is a variable-shift extraction from
three packed words, its reverse complement a 2-bit-group reversal, so
the work per window is O(1) whatever k is — and :func:`hash_windows`,
the K-step formulation over int8 code blocks (the sharded sketch step
and an independent check of the stream kernels).

torch has no unsigned 32-bit arithmetic (uint32 lacks shifts and
compares, int32 ``>>`` is arithmetic), so every u32 lane is carried
widened in int64, holding a value in [0, 2^32): right shifts are then
logical, (hi, lo) compares are unsigned, and left shifts are masked
back to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..params import KssdParams

M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# host helpers
# --------------------------------------------------------------------------

def pack_words_np(codes: np.ndarray) -> tuple[np.ndarray, int, np.ndarray]:
    """int8 codes (-1 invalid) -> (words u32[ceil(n/16)], n, exc i32).

    numpy fallback for the native ``kssd_pack_codes``: base i lands at
    bits 2*(i%16) of word i//16; invalid positions pack as 0 bits and
    are returned as flat positions.
    """
    n = len(codes)
    valid = codes >= 0
    exc = np.nonzero(~valid)[0].astype(np.int32)
    pad = (-n) % 16
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.int8)])
        valid = np.concatenate([valid, np.ones(pad, bool)])
    vals = np.where(valid, codes, 0).astype(np.uint8)
    v4 = vals.reshape(-1, 4)
    packed2 = (v4[:, 0] | (v4[:, 1] << 2) | (v4[:, 2] << 4)
               | (v4[:, 3] << 6)).astype(np.uint8)
    words = np.ascontiguousarray(packed2).view("<u4")
    return words, n, exc


def pack_codes_sparse_np(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int8 codes (-1 invalid) -> (packed2 u8, exception positions i32).

    Four bases a byte, the first in the low bits; invalid positions pack
    as 0 bits and are returned as positions into the flattened
    ``codes``.
    """
    assert codes.shape[-1] % 4 == 0
    valid = codes >= 0
    vals = np.where(valid, codes, 0).astype(np.uint8)
    v4 = vals.reshape(*codes.shape[:-1], -1, 4)
    packed2 = (v4[..., 0] | (v4[..., 1] << 2) | (v4[..., 2] << 4)
               | (v4[..., 3] << 6)).astype(np.uint8)
    exc = np.nonzero(~valid.ravel())[0].astype(np.int32)
    return packed2, exc


def packed_to_words_np(packed2: np.ndarray) -> np.ndarray:
    """Packed 2-bit rows u8[..., B] (B % 4 == 0) -> u32 word rows with 2
    zero pad words appended (the layout :class:`StreamHasher` reads)."""
    assert packed2.shape[-1] % 4 == 0
    w = np.ascontiguousarray(packed2).view("<u4").reshape(
        *packed2.shape[:-1], -1)
    pad = np.zeros((*w.shape[:-1], 2), np.uint32)
    return np.concatenate([w, pad], axis=-1)


def pad_exceptions(exc: np.ndarray, flat_size: int, floor: int = 1024
                   ) -> np.ndarray:
    """Pad exception positions to a power-of-two bucket; pads carry
    ``flat_size`` (one past the last position: the stream step's trash
    slot)."""
    cap = floor
    while cap < len(exc):
        cap <<= 1
    out = np.full(cap, flat_size, np.int32)
    out[: len(exc)] = exc
    return out


_KEPT_CHUNK = 1024


def kept_dims_np(table: np.ndarray, dim_end: int) -> np.ndarray:
    """Sorted int32 dim_ids whose permuted rank survives sampling
    (``0 <= table[d] < dim_end``), padded with -1 to a multiple of 1024
    (1024 -1s when none survives): the JAX package's kept-set form.  The
    port's keep test reads the same set as a bitmap
    (``ops/member.py:keep_tables``)."""
    t = np.asarray(table)
    kept = np.where((t >= 0) & (t < dim_end))[0].astype(np.int32)
    pad = (-len(kept)) % _KEPT_CHUNK
    if pad or len(kept) == 0:
        kept = np.concatenate(
            [kept, np.full(max(pad, _KEPT_CHUNK if len(kept) == 0 else 0),
                           -1, np.int32)])
    return kept


_BASE_LUT_NP = np.full(256, -1, dtype=np.int8)
for _i, _ch in enumerate(b"ACGT"):
    _BASE_LUT_NP[_ch] = _i
    _BASE_LUT_NP[_ch + 32] = _i  # lowercase


def encode_concat(records: list[tuple[bytes, bytes | None]], least_qual: int = 0
                  ) -> np.ndarray:
    """Concatenate a genome's records into one int8 code array.

    Records are separated by a single -1 sentinel so k-mers never span
    record boundaries (kseq record loop, reference sketch.cpp:478-489).
    Low-quality bases (fastq, quality byte < least_qual) are marked
    invalid, mirroring sketch.cpp:795.
    """
    parts: list[np.ndarray] = []
    sep = np.array([-1], dtype=np.int8)
    for seq, qual in records:
        codes = _BASE_LUT_NP[np.frombuffer(seq, dtype=np.uint8)]
        if least_qual > 0 and qual is not None:
            # partial quality (EOF-truncated record) applies as far as read
            q = np.frombuffer(qual, dtype=np.uint8)
            m = min(len(q), len(codes))
            codes = codes.copy()
            codes[:m][q[:m] < least_qual] = -1
        if parts:
            parts.append(sep)
        parts.append(codes)
    if not parts:
        return np.empty(0, dtype=np.int8)
    return np.concatenate(parts)


def pack_blocks(codes: np.ndarray, block: int, K: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Split one genome's code array into [n, block+K-1] halo'd blocks.

    Block b's payload is codes[b*block:(b+1)*block] with the previous
    K-1 codes as halo prefix (first block and tail padded invalid), so
    the windows ending at positions >= K-1 of each row are exactly the
    payload's, each with its true preceding context.
    Returns (codes_blocks int8[n, block+K-1], valid bool[n, block+K-1]).
    """
    n = max(1, -(-len(codes) // block))
    halo = K - 1
    out = np.full((n, block + halo), -1, dtype=np.int8)
    for b in range(n):
        lo = b * block
        hi = min(len(codes), lo + block)
        out[b, halo: halo + (hi - lo)] = codes[lo:hi]
        hlo = max(0, lo - halo)
        out[b, halo - (lo - hlo): halo] = codes[hlo:lo]
    valid = out >= 0
    return out, valid


def combine_hash_words(h_lo: np.ndarray, h_hi: np.ndarray, keep: np.ndarray,
                       use64: bool) -> np.ndarray:
    """Host (lo, hi, keep) window outputs (numpy, or CPU tensors) -> flat
    kept hash values, uint64 for ``use64`` else uint32."""
    lo = np.asarray(h_lo)[np.asarray(keep)]
    if use64:
        hi = np.asarray(h_hi)[np.asarray(keep)]
        return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return lo.astype(np.uint32)


# --------------------------------------------------------------------------
# device part: (hi, lo) bit fields on int64-widened u32 lanes
# --------------------------------------------------------------------------

def _extract_field(lo, hi, start: int, width: int):
    """Bits [start, start+width) of the 64-bit value (hi, lo), width <= 32."""
    assert 0 < width <= 32
    if start >= 32:
        v = hi >> (start - 32)
    elif start + width <= 32:
        v = lo >> start
    else:
        v = (lo >> start) | (hi << (32 - start))
    return v & ((1 << width) - 1)


def _deposit_field(acc_lo, acc_hi, value, shift: int, width: int):
    """OR a (<= 32-bit) value into (hi, lo) at a static bit offset."""
    if shift >= 32:
        return acc_lo, acc_hi | ((value << (shift - 32)) & M32)
    acc_lo = acc_lo | ((value << shift) & M32)
    if shift + width > 32:
        acc_hi = acc_hi | (value >> (32 - shift))
    return acc_lo, acc_hi


def _rev2_32(x):
    """Reverse the order of the 16 2-bit groups of each 32-bit lane."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def _windows_all_valid(valid: torch.Tensor, K: int) -> torch.Tensor:
    """True where the K positions ending here are all valid (cumsum)."""
    L = valid.shape[-1]
    csum = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32)
    behind = F.pad(csum, (K, 0))[..., :L]
    pos_ok = torch.arange(L, device=valid.device) >= K - 1
    return ((csum - behind) == K) & pos_ok


class StreamHasher:
    """Window hash over packed word rows for fixed params.

    :meth:`windows` gives every window's canonical code, its dim_id and
    its all-valid flag, :meth:`at` the canonical code and dim_id of
    given windows only; :meth:`compose` forms a survivor's reduced hash
    from its canonical code and permuted rank (sketch.cpp:524).
    ``csrc/stream_hash.cuh`` is the same hash in CUDA.
    """

    def __init__(self, params: KssdParams):
        p = params
        self.K = p.kmer_size
        self.TB = 2 * p.kmer_size  # window bits
        self.hoc2 = 2 * p.half_outctx_len
        self.subk4 = 4 * p.half_subk
        self.pf_bits = 4 * (p.half_subk - p.drlevel)
        self.dimsize_mask = p.dim_size - 1

    def _fwd_mask(self, lo, hi):
        TB = self.TB
        if TB >= 64:
            return lo, hi
        if TB > 32:
            return lo, hi & ((1 << (TB - 32)) - 1)
        if TB == 32:
            return lo, torch.zeros_like(hi)
        return lo & ((1 << TB) - 1), torch.zeros_like(hi)

    def windows(self, words: torch.Tensor, valid: torch.Tensor):
        """(words int32[nb, nw] — the u32 word rows viewed as int32, 16
        bases per word, 2 zero pad words per row; valid bool[nb, L],
        L = 16*(nw-2)) -> (uni_lo, uni_hi int64[nb, L] in [0, 2^32),
        dim_id int32[nb, L], ok bool[nb, L]) for the window ending at
        each position."""
        K = self.K
        nw = words.shape[-1]
        L = 16 * (nw - 2)
        w = F.pad(words.to(torch.int64) & M32, (2, 0))  # 2 zero words left
        s = torch.arange(L, device=words.device) - (K - 1)  # window start
        widx = (s >> 4) + 2  # >= 0: K - 1 <= 31
        uni_lo, uni_hi, dim_id = self._canonical(
            w[:, widx], w[:, widx + 1], w[:, widx + 2], 2 * (s & 15))
        return uni_lo, uni_hi, dim_id, _windows_all_valid(valid, K)

    def at(self, words: torch.Tensor, p: torch.Tensor, halo: int):
        """The windows ending at payload positions ``p`` (int64, flat
        over the rows: row p // block, position p % block + halo, with
        block = L - halo) -> (uni_lo, uni_hi int64, dim_id int32) of
        p's shape: :meth:`windows` at O(1) a position."""
        nw = words.shape[-1]
        block = 16 * (nw - 2) - halo
        row = p // block
        s = p - row * block + halo - (self.K - 1)  # >= 0: halo >= K - 1
        base = row * nw + (s >> 4)
        w = words.reshape(-1)
        a, b, c = ((w[base + i].to(torch.int64) & M32) for i in range(3))
        return self._canonical(a, b, c, 2 * (s & 15))

    def _canonical(self, a, b, c, sh):
        """Canonical code and dim_id of the windows whose oldest base is
        bit ``sh`` of word ``a`` (``b``, ``c`` the next two words)."""
        ish = 32 - sh
        # E = the window's stream bits, oldest base in the low bits (a
        # shift by 32 leaves only bits >= 32, which the mask drops)
        e_lo, e_hi = self._fwd_mask(((a >> sh) | (b << ish)) & M32,
                                    ((b >> sh) | (c << ish)) & M32)
        # reverse complement (newest base in the high bits) = ~E
        r_lo, r_hi = self._fwd_mask(e_lo ^ M32, e_hi ^ M32)
        # forward code (newest base in the low bits) = 2-bit reversal of E
        t_lo, t_hi = _rev2_32(e_hi), _rev2_32(e_lo)
        shift = 64 - self.TB
        if shift == 0:
            f_lo, f_hi = t_lo, t_hi
        elif shift < 32:
            f_lo = ((t_lo >> shift) | (t_hi << (32 - shift))) & M32
            f_hi = t_hi >> shift
        else:
            f_lo = t_hi >> (shift - 32)
            f_hi = torch.zeros_like(t_hi)
        f_lo, f_hi = self._fwd_mask(f_lo, f_hi)

        use_fwd = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
        uni_lo = torch.where(use_fwd, f_lo, r_lo)
        uni_hi = torch.where(use_fwd, f_hi, r_hi)
        dim_id = (_extract_field(uni_lo, uni_hi, self.hoc2, self.subk4)
                  & self.dimsize_mask).to(torch.int32)
        return uni_lo, uni_hi, dim_id

    def compose(self, uni_lo, uni_hi, pf):
        """Reduced hash (h_lo, h_hi int64 in [0, 2^32)) from the
        canonical window and its permuted rank ``pf``."""
        h_lo = pf.to(torch.int64) & M32
        h_hi = torch.zeros_like(h_lo)
        hoc2 = self.hoc2
        if hoc2 > 0:
            low_outer = _extract_field(uni_lo, uni_hi, 0, hoc2)
            high_outer = _extract_field(uni_lo, uni_hi, hoc2 + self.subk4,
                                        hoc2)
            h_lo, h_hi = _deposit_field(h_lo, h_hi, low_outer, self.pf_bits,
                                        hoc2)
            h_lo, h_hi = _deposit_field(h_lo, h_hi, high_outer,
                                        self.pf_bits + hoc2, hoc2)
        return h_lo, h_hi


# --------------------------------------------------------------------------
# the K-step formulation over int8 code blocks
# --------------------------------------------------------------------------

def _shift_right(x: torch.Tensor, t: int) -> torch.Tensor:
    """x[..., i] -> x[..., i - t] along the last axis, zero-filled."""
    if t == 0:
        return x
    return F.pad(x, (t, 0))[..., : x.shape[-1]]


def _window_codes(codes: torch.Tensor, K: int):
    """Forward and reverse-complement codes (fwd_lo, fwd_hi, rvs_lo,
    rvs_hi, int64 in [0, 2^32)) of the window *ending* at each position
    of ``codes`` (int64[..., L] in 0..3): K shift-ORs.  fwd holds the
    newest base in the low bits (reference ``tuple``, sketch.cpp:502),
    rvs the complement with the newest base in the high bits
    (``rvs_tuple``, sketch.cpp:503).  Positions before the row start
    shift in as base 0 (complement 3)."""
    zeros = torch.zeros_like(codes)
    fwd_lo = fwd_hi = rvs_lo = rvs_hi = zeros
    for t in range(K):
        s = _shift_right(codes, t)  # the base at window offset t, newest 0
        c = s ^ 3
        off = 2 * t
        if off < 32:
            fwd_lo = fwd_lo | (s << off)
        else:
            fwd_hi = fwd_hi | (s << (off - 32))
        off2 = 2 * (K - 1 - t)
        if off2 < 32:
            rvs_lo = rvs_lo | (c << off2)
        else:
            rvs_hi = rvs_hi | (c << (off2 - 32))
    return fwd_lo, fwd_hi, rvs_lo, rvs_hi


def hash_windows(params: KssdParams):
    """Block hash for fixed params, the counterpart of the JAX
    ``hash_windows``.

    Returned fn: (codes int8[..., L], valid bool[..., L], table
    int32[dim_size], all on one device) -> (h_lo, h_hi int64[..., L] in
    [0, 2^32), keep bool[..., L]) on that device, for the window that
    ends at each position; positions < K-1 and windows holding an
    invalid base have keep False.  The composition is sketch.cpp:524's,
    as :meth:`StreamHasher.compose` forms it.  Plain torch ops: K
    shift-ORs, a cumsum validity test and one gather into ``table``.
    """
    K = params.kmer_size
    hasher = StreamHasher(params)
    dim_end = params.dim_end

    def hash_blocks(codes, valid, table):
        c = torch.where(valid, codes.to(torch.int64), 0)
        fwd_lo, fwd_hi, rvs_lo, rvs_hi = _window_codes(c, K)
        ok = _windows_all_valid(valid, K)
        use_fwd = (fwd_hi < rvs_hi) | ((fwd_hi == rvs_hi) & (fwd_lo <= rvs_lo))
        uni_lo = torch.where(use_fwd, fwd_lo, rvs_lo)
        uni_hi = torch.where(use_fwd, fwd_hi, rvs_hi)
        dim_id = (_extract_field(uni_lo, uni_hi, hasher.hoc2, hasher.subk4)
                  & hasher.dimsize_mask)
        # one gather into the permutation table (sketch.cpp:519)
        pf = table[dim_id]
        keep = ok & (pf >= 0) & (pf < dim_end)
        h_lo, h_hi = hasher.compose(uni_lo, uni_hi, pf)
        return h_lo, h_hi, keep

    return hash_blocks


def make_hash_kernel(params: KssdParams):
    """:func:`hash_windows` (the JAX package jits it; torch runs eagerly)."""
    return hash_windows(params)
