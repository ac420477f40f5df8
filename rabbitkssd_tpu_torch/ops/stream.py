"""The sketch stream step's two kernels: keep words, then compact + append.

:func:`keep_words` is the window hash fused with the keep test
(``csrc/stream_keep.cu``): word rows and the valid mask in, one keep bit
per payload window out, 32 to an int32 word.  :func:`compact_append`
(``csrc/stream_compact.cu``) ranks the survivors of those words, forms
each one's reduced hash and appends it to the carry buffers.  Each
wrapper launches its kernel on a CUDA tensor (counted in ``.launches``)
or raises, and runs its plain PyTorch version (``*_plain``, the JAX
``_stream_step_body`` computation as torch ops) on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_cuda_lib
from .kmer import M32, StreamHasher
from .member import KeepTables, member_plain


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_bits(keep: torch.Tensor) -> torch.Tensor:
    """bool[n] -> int32[ceil(n/32)] words, window 32*g + j at bit j of
    word g (the last word's unused bits 0)."""
    n = keep.numel()
    G = -(-n // 32)
    k = torch.zeros(G * 32, dtype=torch.int64, device=keep.device)
    k[:n] = keep.reshape(-1)
    bits = torch.arange(32, device=keep.device)
    return _to_i32((k.view(G, 32) << bits).sum(dim=1))


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`pack_bits` inverted: int32[G] -> bool[n]."""
    bits = torch.arange(32, device=words.device)
    w = words.to(torch.int64) & M32
    return (((w[:, None] >> bits) & 1) != 0).reshape(-1)[:n]


def _geometry(words: torch.Tensor, halo: int) -> tuple[int, int, int, int]:
    """(nb, L, block, G) of a batch of word rows."""
    nb, nw = words.shape
    L = 16 * (nw - 2)
    block = L - halo
    return nb, L, block, -(-(nb * block) // 32)


# --------------------------------------------------------------------------
# keep words: window hash + keep test + group bits
# --------------------------------------------------------------------------

def keep_words_plain(words: torch.Tensor, valid: torch.Tensor,
                     valid_upto: int, hasher: StreamHasher, halo: int,
                     bitmap: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch keep words (any device): :meth:`StreamHasher.windows`
    + :func:`member_plain` + the bit packing."""
    nb, L, block, _ = _geometry(words, halo)
    dev = words.device
    coord = (torch.arange(nb, device=dev)[:, None] * block
             + torch.arange(L, device=dev)[None, :] - halo)
    v = valid[: nb * L].view(nb, L) & (coord < valid_upto)
    _, _, dim_id, ok = hasher.windows(words, v)
    hit = member_plain(dim_id, bitmap, hasher.dimsize_mask + 1)
    return pack_bits((ok & hit)[:, halo:].reshape(-1))


def keep_words(words: torch.Tensor, valid: torch.Tensor, valid_upto: int,
               hasher: StreamHasher, halo: int, tables: KeepTables
               ) -> torch.Tensor:
    """Keep bits of every payload window of a batch, 32 to a word.

    ``words`` int32[nb, nw] word rows; ``valid`` bool[>= nb*L], the
    row-major validity of each row position (L = 16*(nw-2)); payload
    coordinates >= ``valid_upto`` are invalid; ``tables`` the kept set
    (:func:`keep_tables`).  Returns int32[ceil(nb*block/32)] over the
    flattened payload (block = L - halo).  CUDA tensors launch
    ``kssd_stream_keep`` (with the bitmap's summary) or raise; CPU
    tensors run :func:`keep_words_plain`.
    """
    dev = words.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"keep_words: unsupported device {dev}")
    bitmap = tables.bitmap
    if valid.device != dev or bitmap.device != dev:
        raise ValueError(f"keep_words: valid on {valid.device}, bitmap on "
                         f"{bitmap.device}, words on {dev}")
    if tables.dim_size != hasher.dimsize_mask + 1:
        raise ValueError(f"keep_words: kept set of {tables.dim_size} dims, "
                         f"hasher of {hasher.dimsize_mask + 1}")
    if dev.type == "cpu":
        return keep_words_plain(words, valid, valid_upto, hasher, halo,
                                bitmap)
    nb, L, block, G = _geometry(words, halo)
    if words.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("keep_words: words int32, valid bool")
    if not (words.is_contiguous() and valid.is_contiguous()):
        raise ValueError("keep_words: inputs must be contiguous")
    if valid.data_ptr() % 16:
        raise ValueError("keep_words: valid must be 16-byte aligned (the "
                         "kernel loads it 16 bytes at a time)")
    if (valid.numel() < nb * L or not 0 < nb < 1 << 16 or block <= 0
            or halo < hasher.K - 1 or tables.dim_size >= 1 << 31):
        raise ValueError("keep_words: bad shapes")
    out = torch.empty(G, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _keep_lib().kssd_stream_keep(
            words.data_ptr(), nb, words.shape[1], valid.data_ptr(), halo,
            int(valid_upto), hasher.K, hasher.hoc2, bitmap.data_ptr(),
            tables.dim_size, tables.summary.data_ptr(),
            tables.summary.numel(), tables.shift, out.data_ptr(), G, stream)
    if rc != 0:
        raise RuntimeError(f"kssd_stream_keep launch failed: CUDA error {rc}")
    keep_words.launches += 1
    return out


keep_words.launches = 0


def _keep_lib() -> ctypes.CDLL:
    lib = load_cuda_lib("stream_keep.cu")
    fn = lib.kssd_stream_keep
    if fn.argtypes is None:
        c = ctypes
        fn.restype = c.c_int
        fn.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_void_p, c.c_int,
                       c.c_longlong, c.c_int, c.c_int, c.c_void_p,
                       c.c_int32, c.c_void_p, c.c_int, c.c_int, c.c_void_p,
                       c.c_longlong, c.c_void_p]
    return lib


# --------------------------------------------------------------------------
# compact + append
# --------------------------------------------------------------------------

def compact_append_plain(keep: torch.Tensor, words: torch.Tensor,
                         table: torch.Tensor, bufs, count: torch.Tensor,
                         overflow: torch.Tensor, batch_idx: int,
                         hasher: StreamHasher, halo: int, cap: int,
                         buf_cap: int, g_cap: int | None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch compact + append (any device): the JAX stream
    step's compaction on the unpacked keep words, with trash-slot rank
    scatters (torch has no dropping scatter), each survivor's canonical
    code from :meth:`StreamHasher.at`, and in-place carry-buffer writes
    at device-computed offsets.  ``g_cap`` None is dense mode."""
    dev = keep.device
    _, _, block, _ = _geometry(words, halo)
    n = words.shape[0] * block
    kw = keep
    o_flag = torch.zeros((), dtype=torch.bool, device=dev)
    pos_space = None
    if g_cap is not None:
        # sparse: rank the 32-window groups holding any survivor, then
        # compact only the first g_cap of them.  Flagged group g -> slot
        # rank(g) - 1; unflagged groups and ranks >= g_cap -> trash slot
        # g_cap.  Slots beyond n_sel stay 0 (alias group 0) and are
        # masked by grp_ok.
        G = keep.numel()
        gflag = keep != 0
        gcsum = torch.cumsum(gflag, dim=0, dtype=torch.int32)
        n_sel = gcsum[-1]
        gidx = torch.where(gflag & (gcsum <= g_cap), gcsum - 1, g_cap)
        sel = torch.zeros(g_cap + 1, dtype=torch.int32, device=dev)
        sel.scatter_(0, gidx.long(),
                     torch.arange(G, dtype=torch.int32, device=dev))
        sel = sel[:g_cap]
        kw = keep[sel.long()] & torch.where(
            torch.arange(g_cap, device=dev) < n_sel, -1, 0).to(torch.int32)
        pos_space = (sel[:, None] * 32
                     + torch.arange(32, dtype=torch.int32,
                                    device=dev)[None, :]).reshape(-1)
        o_flag = n_sel > g_cap
    keep_c = unpack_bits(kw, n if pos_space is None else kw.numel() * 32)

    # exact compaction by rank scatter: survivor i lands at slot
    # rank(i) - 1 (ascending window order); non-survivors and ranks
    # >= cap go to the trash slot cap.  Slots beyond total stay 0 and
    # are never read (count advances by min(total, cap)).
    csum = torch.cumsum(keep_c, dim=0, dtype=torch.int32)
    total = csum[-1]
    ranks = torch.where(keep_c & (csum <= cap), csum - 1, cap)
    pos_c = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    pos_c.scatter_(0, ranks.long(),
                   torch.arange(keep_c.numel(), dtype=torch.int32,
                                device=dev))
    pos_c = pos_c[:cap]
    if pos_space is not None:
        pos_c = pos_space[pos_c.long()]
    uni_lo, uni_hi, dim_id = hasher.at(words, pos_c.long(), halo)
    out_lo, out_hi = hasher.compose(uni_lo, uni_hi, table[dim_id.long()])

    buf_lo, buf_hi, buf_pos, buf_batch = bufs
    start = torch.clamp(count, max=buf_cap - cap)
    idx = start.long() + torch.arange(cap, device=dev)
    buf_lo.index_copy_(0, idx, _to_i32(out_lo))
    buf_hi.index_copy_(0, idx, _to_i32(out_hi))
    buf_pos.index_copy_(0, idx, pos_c)
    buf_batch.index_fill_(0, idx, batch_idx)
    new_count = start + torch.clamp(total, max=cap)
    overflow = (overflow | o_flag | (total > cap)
                | (count > buf_cap - cap))
    return new_count, overflow


def compact_append(keep: torch.Tensor, words: torch.Tensor,
                   table: torch.Tensor, bufs, count: torch.Tensor,
                   overflow: torch.Tensor, batch_idx: int,
                   hasher: StreamHasher, halo: int, cap: int, buf_cap: int,
                   g_cap: int | None, scratch: LookbackScratch
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Append a batch's survivors to the carry buffers.

    ``keep`` int32[G] from :func:`keep_words`; ``words`` its word rows;
    ``table`` int32[dim_size] the permuted ranks; ``bufs`` (lo, hi, pos,
    batch) int32[buf_cap], written at [start, start + min(total, cap)),
    start = min(count, buf_cap - cap); ``count`` int32 and ``overflow``
    bool device scalars.  ``g_cap`` is the sparse mode's group cap, None
    for dense.  Returns (new count, new overflow) device scalars.  CUDA
    tensors launch ``kssd_stream_compact`` (one pass over tiles of
    :func:`compact_tile_words` keep words, prefixes by look-back through
    ``scratch``, the caller's :class:`LookbackScratch` on this device) or
    raise; CPU tensors run :func:`compact_append_plain`.
    """
    dev = keep.device
    args = (keep, words, table, bufs, count, overflow)
    tensors = (keep, words, table, *bufs, count, overflow)
    if dev.type == "cpu":
        if any(t.device != dev for t in tensors):
            raise ValueError("compact_append: keep on cpu, other inputs not")
        return compact_append_plain(*args, batch_idx, hasher, halo, cap,
                                    buf_cap, g_cap)
    if dev.type != "cuda":
        raise ValueError(f"compact_append: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError("compact_append: inputs on several devices")
    if (any(t.dtype != torch.int32 for t in (keep, words, table, *bufs,
                                             count))
            or overflow.dtype != torch.bool):
        raise TypeError("compact_append: int32 tensors and a bool overflow")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("compact_append: inputs must be contiguous")
    nb, _, block, G = _geometry(words, halo)
    if (keep.numel() != G or any(b.numel() != buf_cap for b in bufs)
            or not 0 < cap <= buf_cap < 1 << 31
            or table.numel() != hasher.dimsize_mask + 1
            or words.numel() >= 1 << 31 or nb * block >= 1 << 31
            or (g_cap is not None and g_cap < 1)):
        raise ValueError("compact_append: bad shapes")
    new_count = torch.empty((), dtype=torch.int32, device=dev)
    new_overflow = torch.empty((), dtype=torch.bool, device=dev)
    lib = _compact_lib()
    tiles = -(-G // lib.tile_words)
    with torch.cuda.device(dev):
        buf, epoch = scratch.take(tiles)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kssd_stream_compact(
            keep.data_ptr(), G, g_cap is not None, g_cap or 0,
            words.data_ptr(), words.shape[1], halo, hasher.K, hasher.hoc2,
            hasher.subk4, hasher.pf_bits, table.numel(), table.data_ptr(),
            *(b.data_ptr() for b in bufs), count.data_ptr(),
            overflow.data_ptr(), new_count.data_ptr(),
            new_overflow.data_ptr(), batch_idx, cap, buf_cap,
            buf.data_ptr(), scratch.tiles, epoch, stream)
    if rc != 0:
        raise RuntimeError(f"kssd_stream_compact launch failed: CUDA error "
                           f"{rc}")
    compact_append.launches += 1
    return new_count, new_overflow


compact_append.launches = 0

# stream_compact's flags carry an epoch in 30 bits
EPOCH_LIMIT = 1 << 30


def scratch_words(tiles: int) -> int:
    """int64 words of the look-back scratch of ``tiles`` tiles: the
    ticket, each tile's aggregate and inclusive prefix, its u32 flag."""
    return 1 + 2 * tiles + -(-tiles // 2)


class LookbackScratch:
    """``stream_compact``'s look-back state on one device.

    One scratch serves the launches of one thread on one stream, which
    run in order; a launch elsewhere needs a scratch of its own.  Made
    zeroed (flags of epoch 0, which no launch uses) and grown to the
    largest tile count seen; each launch takes the next epoch, so no
    launch clears it.  When the epoch would reach ``epoch_limit``
    the state is zeroed once and the epochs start again at 1: a stale
    flag never carries the current epoch.
    """

    def __init__(self, device, epoch_limit: int = EPOCH_LIMIT):
        self.device = device
        self.epoch_limit = epoch_limit
        self.tiles = 0
        self.epoch = 0
        self.buf = None

    def take(self, tiles: int) -> tuple[torch.Tensor, int]:
        """(scratch of >= ``tiles`` tiles, this launch's epoch)."""
        if tiles > self.tiles:
            self.tiles = tiles
            self.buf = torch.zeros(scratch_words(tiles), dtype=torch.int64,
                                   device=self.device)
            self.epoch = 0
        self.epoch += 1
        if self.epoch == self.epoch_limit:
            self.buf.zero_()
            self.epoch = 1
        return self.buf, self.epoch


def compact_tile_words() -> int:
    """Keep words a ``stream_compact`` tile covers (builds the kernel)."""
    return _compact_lib().tile_words


def _compact_lib() -> ctypes.CDLL:
    lib = load_cuda_lib("stream_compact.cu")
    fn = lib.kssd_stream_compact
    if fn.argtypes is None:
        c = ctypes
        fn.restype = c.c_int
        fn.argtypes = [c.c_void_p, c.c_longlong, c.c_int, c.c_int,
                       c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int,
                       c.c_int, c.c_int, c.c_int32, c.c_void_p,
                       c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
                       c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
                       c.c_int, c.c_int, c.c_int, c.c_void_p,
                       c.c_longlong, c.c_uint, c.c_void_p]
        lib.kssd_stream_compact_tile_words.restype = c.c_int
        lib.kssd_stream_compact_tile_words.argtypes = []
        lib.tile_words = lib.kssd_stream_compact_tile_words()
    return lib
