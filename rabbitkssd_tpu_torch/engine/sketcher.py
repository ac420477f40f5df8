"""The sketch pipeline on one torch device: genomes -> stream step -> SketchSet.

Port of ``rabbitkssd_tpu/engine/sketcher.py``.  The design is the JAX
package's: genomes are concatenated into one tape of 2-bit codes, cut
into halo'd word batches (:class:`WordTapeFeeder`), and each batch runs
one device step (window hash -> keep test -> compaction -> compose ->
append to carry buffers).  The host reads the carry buffers once per
flush window, on a flusher thread, and :class:`GenomeFinalizer` dedups
each genome as the tape passes its end.  Capacity overflow is detected
exactly and the window re-runs at full capacity, so results are exact.

In a multi-rank run :class:`DeviceSketcher` splits each batch across
the ranks of a torch.distributed mesh (one process per device) and
all-gathers their survivors at each flush.

Device differences from the JAX step: on a card the step is two
hand-written kernels (ops/stream.py: the window hash fused with the
bitmap keep test, then compaction + compose + append), so the
keep-strategy branches and the sorted-space compaction are gone; the
plain versions (CPU tensors) use trash-slot rank scatters, as torch has
no dropping scatter; carry buffers are updated in place at
device-computed offsets, so no step syncs with the host.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import queue
import sys
import threading
from time import perf_counter as _pc
from time import thread_time as _cpu
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..formats import Sketch, SketchInfo, SketchSet
from ..ops.kmer import StreamHasher, encode_concat, exc_bucket, \
    pack_words_np
from ..ops.member import KeepTables, keep_tables
from ..ops.stream import LookbackScratch, compact_append, keep_words
from ..parallel.multihost import rank, thread_budget
from ..parallel.sharded import Mesh, allgather_columns, any_rank, make_mesh
from ..params import KssdParams
from ..seqio import read_records
from ..shuffle import KeptSet, ShuffleKept
from ..utils.timers import phase, progress_bar_size

# batches per carry-buffer drain: bounds the pending batches' device
# words kept for the overflow re-run, and lets flush + finalize overlap
# the stream (not yet tuned on the card)
FLUSH_WINDOW = 64


def aligned_halo(params: KssdParams) -> int:
    """Halo rounded up to a multiple of 16 so packed rows stay u32-word-
    aligned (any halo >= kmer_size-1 is correct)."""
    return -(-(params.kmer_size - 1) // 16) * 16


# --------------------------------------------------------------------------
# device program: hash + keep + compact + append
# --------------------------------------------------------------------------

class StreamStep:
    """One batch of the sketch stream, appended to device carry buffers.

    ``step(words, exc, tables, bufs, count, overflow, batch_idx,
    valid_upto) -> (count, overflow)``:

    * words int32[nb, nw]: the feeder's u32 word rows viewed as int32;
    * exc int32 or int64[cap_exc]: invalid positions in halo'd-row flat
      coords, padded with nb*L (the trash slot);
    * tables: the :class:`KeepTables` from ``keep_tables``;
    * bufs: (lo, hi, pos, batch) int32[buf_cap] carry buffers, written
      in place from min(count, buf_cap - cap) on;
    * count: int32 device scalar write offset; overflow: bool device
      scalar, sticky (batch survivors > cap, 32-window groups > g_cap,
      or buffer full) — read once per flush, triggering an exact re-run;
    * valid_upto: payload coordinates >= it are invalid (tape tail).

    Four device operations a batch: the valid mask (two torch ops),
    :func:`keep_words` (window hash + keep test, one kernel) and
    :func:`compact_append` (compaction + compose + append, one kernel).
    The step's look-back scratch is made at its first call, on that
    call's device: a step serves one thread, whose launches go to one
    stream.
    """

    def __init__(self, params: KssdParams, cap: int, buf_cap: int,
                 compaction: str = "auto"):
        self.params = params
        self.cap = cap
        self.buf_cap = buf_cap
        self.compaction = compaction
        self.hasher = StreamHasher(params)
        self.halo = aligned_halo(params)
        self.scratch = None

    def __call__(self, words, exc, tables: KeepTables, bufs, count,
                 overflow, batch_idx: int, valid_upto: int):
        p, halo = self.params, self.halo
        if self.scratch is None:
            self.scratch = LookbackScratch(words.device)
        nb, nw = words.shape
        L = 16 * (nw - 2)
        n = nb * (L - halo)
        # pads hit the trash slot nb * L; index_fill_ takes the value as a
        # kernel argument (an indexed assignment would copy it from host)
        valid = torch.ones(nb * L + 1, dtype=torch.bool, device=words.device)
        valid.index_fill_(0, exc.long(), False)
        keep = keep_words(words, valid, valid_upto, self.hasher, halo, tables)
        # survivors are a ~16^-drlevel fraction: at high reduction only
        # the 32-window groups holding any survivor are compacted
        g_cap = None
        if self.compaction == "auto" and p.drlevel >= 3 and n % 32 == 0:
            g_cap = min(n // 32,
                        max(4096, 4 * (n >> (4 * p.drlevel)) // 32))
        return compact_append(keep, words, tables.table, bufs, count,
                              overflow, batch_idx, self.hasher, halo,
                              self.cap, self.buf_cap, g_cap, self.scratch)


# --------------------------------------------------------------------------
# tape feeder (host; copied from the JAX package)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _TapeBatch:
    # words and exc become their device tensors once uploaded (exc
    # padded to its bucket); before that, words is the staging ring's
    # slot that the feeder wrote
    words: np.ndarray  # uint32[n_blocks, (block + halo)/16 + 2]
    exc: np.ndarray  # int32[k] invalid positions, halo'd-row flat coords
    base: int  # tape offset of this batch's first payload position
    valid_upto: int  # payload coords >= this are invalid (tape tail)
    end: int  # tape offset the whole batch covers up to (base +
    # valid_upto of the feeder's batch; a shard keeps it)


class WordTapeFeeder:
    """Concatenates packed genomes into fixed-shape halo'd word batches.

    The tape is word-aligned: every genome starts on a 16-base (one
    u32-word) boundary, padded with 1..16 invalid positions (>= 1 so
    k-mer windows never span genomes; invalid positions generate no
    windows, so extra pads are semantically free).  Batch assembly is
    then pure u32 slicing.

    Source items may be:
      * ``(words u32, n_bases, exc i32)`` — a native-packed genome
      * ``np.int8`` code array — packed here via :func:`pack_words_np`
      * an iterator of either — one genome streamed in bounded chunks
        (multi-GB inputs; every packed chunk except the genome's last
        must hold a multiple of 16 bases)

    Tracks each genome's [start, end) tape span for position->genome
    mapping; invalid positions are carried as tape coordinates and
    emitted per batch in halo'd-row flat coordinates (a position in the
    last ``halo`` of a block also appears in the next row's halo).

    ``rows_out()``, if given, returns the array that the next batch's
    rows are written into, in place of a fresh zeroed one: uint32
    ``[n_blocks, nw_row]`` whose two pad columns are zero; its other
    words may hold anything, as every one is written.  The batch's
    ``words`` is that array.

    Cross-thread invariant: ``starts``/``ends`` are APPEND-ONLY, written
    solely by the producer thread that iterates the feeder, and a
    genome's entries are appended before the batch covering its tape
    span is returned.  The GenomeFinalizer's flusher thread reads them
    without a lock — safe because list appends are atomic under the GIL
    and the flusher only inspects spans at or below an already-flushed
    batch watermark.  A refactor that mutates entries in place, reorders
    flushes ahead of ingestion, or drops the GIL must add a
    snapshot-under-lock here.
    """

    def __init__(self, sources, n_blocks: int, block: int, halo: int,
                 rows_out=None):
        assert block % 16 == 0 and halo % 16 == 0
        self._src = iter(sources)
        self._rows_out = rows_out
        self.n_blocks = n_blocks
        self.block = block
        self.halo = halo
        self.starts: list[int] = []  # genome start offsets (tape coords)
        self.ends: list[int] = []
        self._chunks: collections.deque = collections.deque()
        self._have = 0  # words queued in _chunks
        self._exc: collections.deque = collections.deque()
        # the initial halo (tape coords [-halo, 0)) is invalid
        self._exc.append(np.arange(-halo, 0, dtype=np.int64))
        self._tape = 0  # bases ingested (word-aligned at genome ends)
        self._avail = 0  # bases available as pushed words
        self._open = None  # (iterator, start, total, int8 stage) of the
        # chunked genome being ingested, pulled incrementally so batches
        # flow while a multi-GB genome is still being parsed
        self._exhausted = False
        # the exceptions emitted (halo'd flat positions, before bucket
        # padding) and the seconds spent taking and mapping them
        self.exc_n = 0
        self.exc_s = 0.0

    # -- ingest -------------------------------------------------------------
    def _push(self, words: np.ndarray, exc: np.ndarray, offset: int) -> None:
        if len(words):
            self._chunks.append(words)
            self._have += len(words)
        if len(exc):
            self._exc.append(exc.astype(np.int64) + offset)

    def _pad_genome(self, start: int, n: int) -> None:
        """Close a genome at tape position start+n: pad to the next word
        boundary with >= 1 invalid separators."""
        self.ends.append(start + n)
        pad = 16 - (n % 16) if n % 16 else 16
        if n % 16 == 0:
            self._chunks.append(np.zeros(1, np.uint32))
            self._have += 1
        self._exc.append(np.arange(start + n, start + n + pad,
                                   dtype=np.int64))
        self._tape = start + n + pad
        self._avail = self._tape

    def _append_packed(self, words: np.ndarray, n: int, exc: np.ndarray
                       ) -> None:
        start = self._tape
        self.starts.append(start)
        self._push(words, exc, start)
        self._pad_genome(start, n)

    def _pull_open_chunk(self) -> None:
        """Ingest ONE chunk of the open chunked genome (close on end)."""
        it, start, total, stage = self._open
        try:
            piece = next(it)
        except StopIteration:
            if len(stage):
                w, n, e = pack_words_np(stage)
                self._push(w, e, start + total)
                total += n
            self._pad_genome(start, total)
            self._open = None
            return
        if isinstance(piece, np.ndarray):
            if len(stage):
                piece = np.concatenate([stage, piece])
            cut = len(piece) - (len(piece) % 16)
            stage = piece[cut:]
            if cut == 0:
                self._open = (it, start, total, stage)
                return
            w, n, e = pack_words_np(piece[:cut])
        else:
            w, n, e = piece
            if len(stage):
                raise ValueError("packed chunk after unaligned int8 chunk")
        if total % 16:
            raise ValueError("non-final packed chunk not word-aligned")
        self._push(w, e, start + total)
        total += n
        self._open = (it, start, total, stage)
        self._avail = start + total - (total % 16)

    def _pull_to(self, need_bases: int) -> None:
        while not self._exhausted and self._avail < need_bases:
            if self._open is not None:
                self._pull_open_chunk()
                continue
            try:
                item = next(self._src)
            except StopIteration:
                self._exhausted = True
                return
            if isinstance(item, tuple):
                self._append_packed(*item)
            elif isinstance(item, np.ndarray):
                self._append_packed(*pack_words_np(item))
            else:
                self._open = (iter(item), self._tape, 0,
                              np.empty(0, np.int8))
                self.starts.append(self._tape)

    # -- batch emission -----------------------------------------------------
    def _take_words(self, want: int) -> list[np.ndarray]:
        take = min(want, self._have)
        parts: list[np.ndarray] = []
        got = 0
        while got < take:
            c = self._chunks[0]
            if got + len(c) <= take:
                parts.append(c)
                got += len(c)
                self._chunks.popleft()
            else:
                parts.append(c[: take - got])
                self._chunks[0] = c[take - got :]
                got = take
        self._have -= take
        return parts

    def _take_exc(self, limit: int) -> np.ndarray:
        """Pop queued invalid tape positions < limit (globally ascending)."""
        out: list[np.ndarray] = []
        while self._exc:
            e = self._exc[0]
            if e[-1] < limit:
                out.append(e)
                self._exc.popleft()
            else:
                k = int(np.searchsorted(e, limit))
                if k:
                    out.append(e[:k])
                    self._exc[0] = e[k:]
                break
        return (np.concatenate(out) if out
                else np.empty(0, np.int64))

    def _exc_to_flat(self, exc_tape: np.ndarray, base: int) -> np.ndarray:
        """Tape coords in [base-halo, base+payload) -> halo'd flat coords."""
        block, halo = self.block, self.halo
        L = block + halo
        rel = exc_tape - base
        row = np.maximum(rel // block, 0)  # rel<0 -> row 0 halo
        flat1 = row * L + (rel - row * block + halo)
        dup = (rel >= 0) & (rel % block >= block - halo) \
            & (row + 1 < self.n_blocks)
        row2 = row[dup] + 1
        flat2 = row2 * L + (rel[dup] - row2 * block + halo)
        return np.concatenate([flat1, flat2]).astype(np.int32)

    def __iter__(self) -> Iterator[_TapeBatch]:
        P = self.n_blocks * self.block
        WP, WB, WH = P // 16, self.block // 16, self.halo // 16
        nw_row = WB + WH + 2  # + 2 zero pad words (StreamHasher)
        base = 0
        tail = np.zeros(WH, np.uint32)  # words covering [base-halo, base)
        halo_exc = np.empty(0, np.int64)  # invalid positions in that span
        while True:
            self._pull_to(base + P)
            if self._avail <= base:
                return
            parts = self._take_words(WP)
            flat = np.concatenate([tail, *parts])
            # a tail's rows past the tape are written as zeros too: a
            # reused destination holds the words of an earlier batch
            if len(flat) < WH + WP:
                flat = np.concatenate(
                    [flat, np.zeros(WH + WP - len(flat), np.uint32)]
                )
            rows = (np.zeros((self.n_blocks, nw_row), np.uint32)
                    if self._rows_out is None else self._rows_out())
            # one strided copy: row b is flat[b * WB : b * WB + WB + WH]
            rows[:, : WB + WH] = np.lib.stride_tricks.as_strided(
                flat, shape=(self.n_blocks, WB + WH),
                strides=(WB * flat.itemsize, flat.itemsize), writeable=False)
            tail = flat[WP:].copy()
            t0 = _pc()
            exc_tape = np.concatenate([halo_exc, self._take_exc(base + P)])
            halo_exc = exc_tape[exc_tape >= base + P - self.halo]
            exc = self._exc_to_flat(exc_tape, base)
            self.exc_s += _pc() - t0
            self.exc_n += len(exc)
            valid_upto = min(self._avail - base, P)
            yield _TapeBatch(
                words=rows,
                exc=exc,
                base=base,
                valid_upto=valid_upto,
                end=base + valid_upto,
            )
            base += P
            if self._exhausted and self._avail <= base:
                return


# --------------------------------------------------------------------------
# host threads (copied from the JAX package)
# --------------------------------------------------------------------------

# most threads the chunked reader takes (native.fasta_packed_chunks): on
# an 8-core H100 host the mammal cell read the same at 4 and 5 and less
# at 6, where the parse competes with the pipeline's threads (PERF.md);
# more cores were not measured
_SPLIT_THREADS = 5


def _prefetch_chunks(gen, depth: int = 4, waited=None):
    """Run a chunk generator on its own thread, `depth` chunks ahead.

    The returned iterator yields the same items; exceptions from the
    source re-raise at the consumer.  Abandoning the iterator (error
    mid-pipeline, generator close/GC) cancels the worker and closes the
    source generator — no leaked thread, fd, or buffered chunks.
    ``waited(t0)``, if given, is called after each wait for an item that
    began at ``perf_counter()`` time ``t0``."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    cancelled = threading.Event()

    def run():
        try:
            for item in gen:
                q.put(item)
                if cancelled.is_set():
                    return
        except BaseException as e:
            q.put(e)
            return
        finally:
            close = getattr(gen, "close", None)
            if close is not None:
                close()
        q.put(None)

    threading.Thread(target=run, daemon=True, name="kssd-prefetch").start()

    def out():
        try:
            while True:
                t0 = _pc()
                item = q.get()
                if waited is not None:
                    waited(t0)
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancelled.set()
            try:  # unblock a producer stuck on a full queue
                q.get_nowait()
            except queue.Empty:
                pass

    return out()


class _AsyncFlusher:
    """Runs flush jobs on one dedicated thread, strictly in submission
    order, so the main loop keeps dispatching stream steps into fresh
    carry buffers while a window is read back and finalized.  The queue
    bound caps how many retired buffer windows stay live on device."""

    def __init__(self, fn):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self.error: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="kssd-flush")
        self._t.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            if self.error is None:
                try:
                    self._fn(*job)
                except BaseException as e:  # surfaced by the main thread
                    self.error = e

    def submit(self, *job) -> None:
        if self.error is not None:
            raise self.error
        self._q.put(job)

    def shutdown(self) -> None:
        """Join the worker; never raises (check .error afterwards)."""
        self._q.put(None)
        self._t.join()


# --------------------------------------------------------------------------
# staging: page-locked on CUDA
# --------------------------------------------------------------------------

# batches the producer may run ahead of the consumer
_QUEUE_DEPTH = 8


@dataclasses.dataclass
class _Slot:
    words: torch.Tensor  # int32[n_rows, nw_row], pad columns zero
    rows: np.ndarray  # the same memory as uint32, the feeder's destination
    fence: object  # event recorded after the slot's copies were issued
    exc: torch.Tensor  # int32[region]: the trash slot from n_exc on
    exc_np: np.ndarray  # the same memory
    n_exc: int = 0  # exceptions the slot's last batch wrote


class _Done:
    """The fence of a ring off CUDA, where a copy has ended when it
    returns."""

    def record(self) -> None:
        pass

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


class _StagingRing:
    """Host slots that the producer assembles batches into, and uploads
    from, once each: page-locked, with CUDA events as fences, on CUDA.

    :meth:`take` (the feeder's ``rows_out``) moves to the next slot and,
    if that slot's last copies have not ended, waits on its fence
    (``waits`` counts such batches, ``wait_s`` sums the waits);
    :meth:`exceptions` writes a batch's exceptions into the slot, padded
    with ``trash`` (the step's trash slot) to their bucket, growing the
    slot's region to a larger bucket; :meth:`sent` fences the copies
    just issued from the slot.  Off CUDA the slots are not pinned
    (``pin=False``) and ``fence`` is :class:`_Done`, or any class with
    ``record``, ``query`` and ``synchronize``."""

    def __init__(self, depth: int, n_rows: int, nw_row: int, trash: int,
                 pin: bool = True, fence=None):
        self._pin = pin
        self._trash = trash
        fence = fence or torch.cuda.Event
        self.slots = []
        for _ in range(depth):
            w = torch.empty((n_rows, nw_row), dtype=torch.int32,
                            pin_memory=pin)
            w[:, nw_row - 2:] = 0  # the StreamHasher's pads, never written
            # 4096 exceptions hold a batch's genome-end pads and short N
            # runs; a batch with more grows its slot's region
            self.slots.append(_Slot(w, w.numpy().view(np.uint32), fence(),
                                    *self._region(4096)))
        self._i = -1
        self.waits = 0
        self.wait_s = 0.0

    def _region(self, n: int) -> tuple[torch.Tensor, np.ndarray]:
        e = torch.full((n,), self._trash, dtype=torch.int32,
                       pin_memory=self._pin)
        return e, e.numpy()

    @property
    def slot(self) -> _Slot:
        """The slot last taken."""
        return self.slots[self._i]

    def take(self) -> np.ndarray:
        self._i = (self._i + 1) % len(self.slots)
        s = self.slots[self._i]
        t0 = _pc()
        if not s.fence.query():
            self.waits += 1
            s.fence.synchronize()
        self.wait_s += _pc() - t0
        return s.rows

    def exceptions(self, exc: np.ndarray) -> torch.Tensor:
        s = self.slot
        n, cap = len(exc), exc_bucket(len(exc))
        if cap > len(s.exc):
            s.exc, s.exc_np = self._region(cap)
            s.n_exc = 0
        # past n_exc the region holds the trash slot: only the last
        # batch's surplus goes back to it (a fill of the whole bucket
        # releases the interpreter lock, and the producer then waits to
        # take it back)
        s.exc_np[n:s.n_exc] = self._trash
        s.exc_np[:n] = exc
        s.n_exc = n
        return s.exc[:cap]

    def sent(self) -> None:
        self.slot.fence.record()


# --------------------------------------------------------------------------
# sketcher
# --------------------------------------------------------------------------

def _device_scope(device: torch.device):
    """Make ``device`` current on this thread: CUDA keeps the current
    device per thread, and a helper thread starts on cuda:0."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class DeviceSketcher:
    """Streams genomes through the stream step on one torch device.

    On a mesh of several ranks (port of the JAX ``ShardedSketcher`` and
    its ``make_sharded_stream_step``) every rank runs the same
    deterministic feeder over ``mesh.size * n_blocks`` rows, so batch
    and flush counts are equal on every rank and the collectives pair
    up.  Rank s uploads only its ``n_blocks`` rows and runs
    :class:`StreamStep` on them into its own carry buffers.  At each
    flush (on the flusher thread, in window order; the stream loop
    issues no collective) the ranks OR their overflow flags — on
    overflow each re-runs its own rows of the window at full capacity —
    and all-gather their (hash, tape position) survivors, so every rank
    finalizes every genome and returns the same sketches.
    ``last_budget`` is this rank's, with the gather's seconds under
    ``exchange``.  ``mesh`` defaults to every rank of the process group
    (:func:`make_mesh`): one shard in a single process.
    """

    def __init__(self, params: KssdParams, kept: KeptSet | np.ndarray,
                 device, n_blocks: int = 16, block: int = 1 << 17,
                 least_qual: int = 0, least_num_kmer: int = 1,
                 buf_cap: int = 1 << 23, threads: int = 0,
                 mesh: Mesh | None = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.mesh.check_world()
        self.device = resolve_device(device)
        self.params = params
        self.least_qual = least_qual
        self.least_num_kmer = least_num_kmer
        self.threads = threads
        self.n_blocks = n_blocks
        self.block = block
        self.tables = keep_tables(kept, params.dim_end, self.device)
        n = n_blocks * block
        # per-batch capacity: 4x the expected survivor count, floor 16k
        exp = n >> (4 * params.drlevel)
        self.cap = min(n, max(1 << 14, 4 * exp))
        self.buf_cap = max(buf_cap, 4 * self.cap)
        self.step = StreamStep(params, self.cap, self.buf_cap)
        self.last_budget = None
        self.last_peak_pending = 0

    def _fresh_buffers(self, buf_cap: int):
        dev = self.device
        bufs = tuple(torch.zeros(buf_cap, dtype=torch.int32, device=dev)
                     for _ in range(4))
        return (bufs, torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))

    @functools.cached_property
    def _staging_ring(self) -> _StagingRing:
        """The staging ring, made at the first sketch and kept: page-locked
        on CUDA, unpinned elsewhere."""
        row = self.block + aligned_halo(self.params)
        cuda = self.device.type == "cuda"
        return _StagingRing(_QUEUE_DEPTH + 2, self.mesh.size * self.n_blocks,
                            row // 16 + 2, self.n_blocks * row, pin=cuda,
                            fence=None if cuda else _Done)

    def _upload(self, b: _TapeBatch, ring: _StagingRing):
        """Host batch -> (words, exc) device tensors and the seconds
        spent staging the exceptions.  ``b.words`` is (this rank's rows
        of) the slot that the feeder wrote; the exceptions go into the
        same slot as int32, padded with the ring's ``trash`` (the flat
        batch size), and both are copied asynchronously into fresh
        device tensors; the slot's fence keeps the producer from writing
        it again before the copies end."""
        t0 = _pc()
        e = ring.exceptions(b.exc)
        pin = _pc() - t0
        # copy=True: off CUDA, too, the batch must not alias the slot
        w = b.words.to(self.device, non_blocking=True, copy=True)
        e = e.to(self.device, non_blocking=True, copy=True)
        ring.sent()
        return w, e, pin

    def _pinned_allocs(self) -> int | None:
        """Pinned blocks the caching host allocator has made so far in
        this process: 0 off CUDA, None where torch keeps no such count
        (its stats are empty until the first pinned block, too)."""
        if self.device.type != "cuda":
            return 0
        return torch.cuda.host_memory_stats().get("num_host_alloc")

    def _local(self, b: _TapeBatch) -> _TapeBatch:
        """This rank's shard of a feeder batch, sliced on the host before
        the upload."""
        if self.mesh.size == 1:
            return b
        s, nb = rank(), self.n_blocks
        payload = nb * self.block
        flat = nb * (self.block + aligned_halo(self.params))
        # flat coords are row-major over all mesh.size * n_blocks rows
        mine = b.exc // flat == s
        return _TapeBatch(
            words=b.words[s * nb : (s + 1) * nb],
            exc=b.exc[mine] - s * flat,
            base=b.base + s * payload,
            valid_upto=int(np.clip(b.valid_upto - s * payload, 0, payload)),
            end=b.end)

    def _merge(self, hash_chunks: list, pos_chunks: list) -> None:
        """Replace this rank's survivor chunks by every rank's."""
        h = (np.concatenate(hash_chunks) if hash_chunks
             else np.empty(0, np.uint64))
        pos = (np.concatenate(pos_chunks) if pos_chunks
               else np.empty(0, np.int64))
        dt = np.uint64 if self.params.use64 else np.uint32
        every = allgather_columns(
            np.stack([h.astype(np.uint64).view(np.int64), pos]))
        hash_chunks[:] = [x[0].view(np.uint64).astype(dt) for x in every]
        pos_chunks[:] = [x[1] for x in every]

    # -- core ---------------------------------------------------------------
    def sketch_codes(self, genome_codes: Iterator[np.ndarray]
                     ) -> tuple[list[np.ndarray], int]:
        """Run the pipeline over per-genome code arrays.

        Returns (per-genome sorted-unique hash arrays, n_genomes).  No
        per-batch host sync: survivors accumulate in device carry
        buffers, read back once per flush window.
        """
        self.last_budget = None
        p = self.params
        halo = aligned_halo(p)
        payload = self.n_blocks * self.block
        allocs = self._pinned_allocs() or 0  # the ring's first blocks too
        ring = self._staging_ring
        feeder = WordTapeFeeder(genome_codes, self.mesh.size * self.n_blocks,
                                self.block, halo, rows_out=ring.take)
        pos_chunks: list[np.ndarray] = []
        hash_chunks: list[np.ndarray] = []
        finalizer = GenomeFinalizer(feeder, p, self.least_num_kmer)
        window = max(1, min(self.buf_cap // self.cap - 1, FLUSH_WINDOW))
        pending: list[_TapeBatch] = []
        bufs, count, overflow = self._fresh_buffers(self.buf_cap)

        # itemized wall budget (read via .last_budget): the three threads
        # overlap, so components sum to MORE than the wall unless one
        # role is the bottleneck.  Parts of one role: parse_wait of feed
        # (the producer blocked on the parser; sketch_files sets it) and
        # pin of h2d_put (the wait for a free ring slot, which the
        # feeder takes and which moves from feed to h2d_put at the end,
        # plus the exceptions' copy into the slot).  slot_waits:
        # batches whose slot was still being copied from.  consumer_cpu:
        # the consumer thread's CPU seconds over its whole loop
        # (dispatch, qwait and the flush hand-offs), read at the loop's
        # ends only: a read a batch (a system call each) made dispatch
        # 2.6x slower on an H100 host (PERF.md §6).  It does not tell
        # the step's work from waits that cost CPU time.  exceptions:
        # the invalid positions the feeder emitted, before bucket
        # padding; exc_build, a part of feed: the feeder taking them
        # and mapping them to flat coordinates; abundance, a part of
        # finalize: the count and filter of -n > 1.  keep_bytes_up: the
        # bytes keep_tables copied to the device; keep_threads: the
        # threads of the shuffle file's pass (0: NumPy or in memory).
        B = {"feed": 0.0, "h2d_put": 0.0, "qwait": 0.0, "dispatch": 0.0,
             "flush_scalars": 0.0, "flush_collect": 0.0, "finalize": 0.0,
             "drain": 0.0, "wall": 0.0, "h2d_bytes": 0, "batches": 0,
             "reruns": 0, "exchange": 0.0, "parse_wait": 0.0, "pin": 0.0,
             "pinned_allocs": 0, "consumer_cpu": 0.0, "slot_waits": 0,
             "exceptions": 0, "exc_build": 0.0, "abundance": 0.0,
             "keep_bytes_up": self.tables.bytes_up,
             "keep_threads": self.tables.threads}
        waits0, wait_s0 = ring.waits, ring.wait_s
        t_start = _pc()

        def collect(cur_bufs, cur_count, pending_batches):
            t0 = _pc()
            n = int(cur_count)
            B["flush_scalars"] += _pc() - t0
            if n == 0:
                return
            t0 = _pc()
            lo_b, hi_b, pos_b, bat_b = cur_bufs
            lo = lo_b[:n].cpu().numpy().view(np.uint32)
            pos = pos_b[:n].cpu().numpy().astype(np.int64)
            bidx = bat_b[:n].cpu().numpy()
            base = np.array([b.base for b in pending_batches], np.int64)
            if p.use64:
                h = hi_b[:n].cpu().numpy().view(np.uint32).astype(
                    np.uint64) << np.uint64(32)
                h |= lo.astype(np.uint64)
            else:
                h = lo.copy()
            hash_chunks.append(h)
            pos_chunks.append(base[bidx] + pos)
            B["flush_collect"] += _pc() - t0

        def rerun(pending_batches):
            """Exact fallback: re-run the window one batch at a time at
            full capacity (dense compaction, cap = payload)."""
            full = StreamStep(p, payload, max(self.buf_cap, 2 * payload),
                              compaction="dense")
            for b in pending_batches:
                fb, fc, fo = self._fresh_buffers(full.buf_cap)
                fc, fo = full(b.words, b.exc, self.tables, fb, fc, fo, 0,
                              b.valid_upto)
                if bool(fo):
                    raise RuntimeError(
                        "sketch capacity overflow in fallback path")
                collect(fb, fc, [b])
                B["reruns"] += 1

        def flush(cur, pending_batches):
            cur_bufs, cur_count, cur_overflow = cur
            with _device_scope(self.device):
                t0 = _pc()
                oflow = any_rank(bool(cur_overflow))
                B["flush_scalars"] += _pc() - t0
                if oflow:
                    rerun(pending_batches)
                else:
                    collect(cur_bufs, cur_count, pending_batches)
            if self.mesh.size > 1:
                t0 = _pc()
                self._merge(hash_chunks, pos_chunks)
                B["exchange"] += _pc() - t0
            t0 = _pc()
            finalizer.add(hash_chunks, pos_chunks, pending_batches[-1].end)
            B["finalize"] += _pc() - t0

        # producer thread: feed + pinned upload overlap device execution
        q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)

        def producer():
            try:
                it = iter(feeder)
                with _device_scope(self.device):
                    while True:
                        t0 = _pc()
                        batch = next(it, None)
                        B["feed"] += _pc() - t0
                        if batch is None:
                            break
                        batch.words = ring.slot.words  # the feeder wrote it
                        batch = self._local(batch)
                        t0 = _pc()
                        dw, de, pin = self._upload(batch, ring)
                        B["h2d_put"] += _pc() - t0
                        B["pin"] += pin
                        B["h2d_bytes"] += batch.words.nbytes
                        B["batches"] += 1
                        # the pending batch keeps only its device tensors,
                        # for the rare overflow re-run
                        batch.words, batch.exc = dw, de
                        q.put(batch)
            except BaseException as e:  # surface in consumer
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True, name="kssd-feed")
        t.start()
        flusher = _AsyncFlusher(flush)
        cpu0 = _cpu()
        try:
            while True:
                t0 = _pc()
                batch = q.get()
                B["qwait"] += _pc() - t0
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                if len(pending) == window:
                    flusher.submit((bufs, count, overflow), pending)
                    bufs, count, overflow = self._fresh_buffers(self.buf_cap)
                    pending = []
                t0 = _pc()
                count, overflow = self.step(
                    batch.words, batch.exc, self.tables, bufs, count,
                    overflow, len(pending), batch.valid_upto)
                B["dispatch"] += _pc() - t0
                pending.append(batch)
            B["consumer_cpu"] = _cpu() - cpu0
            t.join()
            t_loop_end = _pc()
            if pending:
                flusher.submit((bufs, count, overflow), pending)
        finally:
            flusher.shutdown()
        if flusher.error is not None:
            raise flusher.error
        B["drain"] = _pc() - t_loop_end
        waited = ring.wait_s - wait_s0
        B["feed"] -= waited
        B["h2d_put"] += waited
        B["pin"] += waited
        B["slot_waits"] = ring.waits - waits0
        B["exceptions"] = feeder.exc_n
        B["exc_build"] = feeder.exc_s

        self.last_peak_pending = finalizer.peak_pending
        t0 = _pc()
        out = finalizer.finish()
        B["finalize"] += _pc() - t0
        B["abundance"] = finalizer.abundance_s
        B["wall"] = _pc() - t_start
        n = self._pinned_allocs()
        B["pinned_allocs"] = None if n is None else n - allocs
        self.last_budget = {k: (round(v, 4) if isinstance(v, float) else v)
                            for k, v in B.items()}
        return out

    # -- file-level API -------------------------------------------------------
    def sketch_files(self, files: list[str]) -> SketchSet:
        """Sketch each file as one genome (the reference's per-file unit,
        sketch.cpp:455-566), largest file first (stable), matching the
        reference's size-descending schedule (sketch.cpp:39-41, 348-378)
        which also fixes the i/j orientation of distance rows."""
        from concurrent.futures import ThreadPoolExecutor

        from ..native import fasta_packed, fasta_packed_chunks, load_native

        sizes = [os.stat(f).st_size for f in files]
        order = sorted(range(len(files)), key=lambda i: -sizes[i])
        files = [files[i] for i in order]
        # files beyond this stream through the chunked native reader
        # instead of materializing their whole packed tape
        stream_threshold = int(
            os.environ.get("KSSD_STREAM_THRESHOLD", 1 << 30))

        budget = thread_budget(self.threads)
        # the chunked reader's threads: the budget less a core each for
        # the producer, consumer and flusher, at most _SPLIT_THREADS
        split_threads = min(_SPLIT_THREADS, max(1, budget - 3))
        streamed: list = []  # the chunked readers, for their counters
        # one file streams at a time, on all of split_threads, in the
        # producer's order: the k-th file that streams waits until the k
        # before it have ended (their prefetch threads start in any order)
        can_stream = load_native() is not None
        turn = threading.Condition()
        ended = [0]
        placed = [0]

        def place(path: str):
            """The file's place in line among those that stream, or None."""
            if not can_stream or os.stat(path).st_size <= stream_threshold:
                return None
            placed[0] += 1
            return placed[0] - 1

        def stream(path: str, k: int):
            try:
                with turn:
                    turn.wait_for(lambda: ended[0] == k)
                chunks = fasta_packed_chunks(path, self.least_qual,
                                             threads=split_threads)
                streamed.append(chunks)
                yield from chunks
            finally:
                with turn:
                    ended[0] += 1
                    turn.notify_all()

        def parse(path: str, k):
            if k is not None:
                return _prefetch_chunks(stream(path, k), waited=waited)
            pk = fasta_packed(path, self.least_qual)
            if pk is None:  # no native toolchain: python parser
                recs = [(r.seq, r.qual) for r in read_records(path)]
                pk = pack_words_np(encode_concat(recs, self.least_qual))
            return pk

        parse_wait = 0.0

        def waited(t0: float) -> None:
            # on the producer thread: it blocked on the parser since t0
            nonlocal parse_wait
            parse_wait += _pc() - t0

        def result(fut):
            t0 = _pc()
            got = fut.result()
            waited(t0)
            return got

        def gen() -> Iterator:
            # bounded parallel parse (the native parser releases the GIL)
            workers = self.threads or min(8, budget)
            depth = 2 * workers
            with ThreadPoolExecutor(max_workers=workers) as ex:
                futs: list = []
                it = iter(files)
                for path in it:
                    futs.append(ex.submit(parse, path, place(path)))
                    if len(futs) >= depth:
                        break
                ring = len(futs)
                i = 0
                for path in it:
                    yield result(futs[i % ring])
                    futs[i % ring] = ex.submit(parse, path, place(path))
                    i += 1
                for j in range(ring):
                    yield result(futs[(i + j) % ring])

        step_pb = progress_bar_size(len(files))

        def gen_progress():
            for i, codes in enumerate(gen()):
                if i % step_pb == 0:
                    print(f"finshed sketching: {i} genomes", file=sys.stderr)
                yield codes

        with phase("stream pipeline"):
            hashes, n = self.sketch_codes(gen_progress())
        self.last_budget["parse_wait"] = round(parse_wait, 4)
        # the chunked reader's bytes, and those whose split parse held
        for key in ("stream_bytes", "split_bytes"):
            self.last_budget[key] = sum(getattr(c, key, 0) for c in streamed)
        # one JSON line: where the pipeline's wall went, per thread role
        print(f"sketch budget: {json.dumps(self.last_budget)}",
              file=sys.stderr)
        if n != len(files):
            raise RuntimeError(f"sketched {n} genomes of {len(files)} files")
        p = self.params
        info = SketchInfo(
            id=p.sketch_id, half_k=p.half_k, half_subk=p.half_subk,
            drlevel=p.drlevel, genome_number=len(files),
        )
        sketches = [Sketch(name=f, hashes=h) for f, h in zip(files, hashes)]
        return SketchSet(info=info, sketches=sketches)


class GenomeFinalizer:
    """Per-genome sketch finalization as the tape passes genome ends.

    Survivor (hash, tape-position) chunks arrive per flush window; any
    genome whose [start, end) span lies entirely below the flushed
    watermark is final — its survivors are deduplicated (np.unique, plus
    the fastq abundance filter) and freed immediately, so host memory is
    bounded by one flush window's survivors plus any genome still in
    flight (the reference frees each per-genome hash set the same way,
    sketch.cpp:529,434-447).
    """

    def __init__(self, feeder: WordTapeFeeder, p: KssdParams,
                 least_num_kmer: int):
        self.feeder = feeder
        self.dt = np.uint64 if p.use64 else np.uint32
        self.least = least_num_kmer
        self._h: list[np.ndarray] = []  # pending survivor hashes
        self._p: list[np.ndarray] = []  # ... and their tape positions
        self._next = 0  # next genome index to finalize
        self.out: list[np.ndarray] = []
        self.peak_pending = 0  # max survivors ever held (for tests)
        self.abundance_s = 0.0  # seconds in the count and filter of -n

    def _finalize_upto(self, g_hi: int) -> None:
        if g_hi <= self._next:
            return
        if self._h:
            allh = np.concatenate(self._h)
            allp = np.concatenate(self._p)
        else:
            allh = np.empty(0, self.dt)
            allp = np.empty(0, np.int64)
        self._h.clear()
        self._p.clear()
        self.peak_pending = max(self.peak_pending, allh.size)
        starts = np.asarray(self.feeder.starts, dtype=np.int64)
        gidx = np.searchsorted(starts, allp, side="right") - 1
        order = np.argsort(gidx, kind="stable")
        gsorted = gidx[order]
        hsorted = allh[order]
        psorted = allp[order]
        bounds = np.searchsorted(gsorted, np.arange(self._next, g_hi + 1))
        for i in range(g_hi - self._next):
            h = hsorted[bounds[i]: bounds[i + 1]]
            if self.least > 1:
                t0 = _pc()
                vals, counts = np.unique(h, return_counts=True)
                vals = vals[counts >= self.least]
                self.abundance_s += _pc() - t0
            else:
                vals = np.unique(h)
            self.out.append(vals.astype(self.dt))
        if bounds[-1] < hsorted.size:  # survivors of unfinished genomes
            self._h.append(hsorted[bounds[-1]:])
            self._p.append(psorted[bounds[-1]:])
        self._next = g_hi

    def add(self, hash_chunks: list[np.ndarray],
            pos_chunks: list[np.ndarray], upto: int) -> None:
        """Ingest one flush window's survivor chunks (consumes the
        lists) and finalize every genome that ended at tape position
        <= ``upto``."""
        self._h.extend(hash_chunks)
        self._p.extend(pos_chunks)
        hash_chunks.clear()
        pos_chunks.clear()
        ends = self.feeder.ends
        g_hi = self._next
        while g_hi < len(ends) and ends[g_hi] <= upto:
            g_hi += 1
        self._finalize_upto(g_hi)

    def finish(self) -> tuple[list[np.ndarray], int]:
        self._finalize_upto(len(self.feeder.ends))
        n = len(self.feeder.starts)
        while len(self.out) < n:  # trailing genomes with zero survivors
            self.out.append(np.empty(0, self.dt))
        return self.out, n


def sketch_file_list(list_path: str, shuf, device, least_qual: int = 0,
                     least_num_kmer: int = 1, threads: int = 0,
                     **kw) -> SketchSet:
    """List-of-files entry point (the command_sketch engine, reference
    subCommand.cpp:50-68).

    ``shuf``: a ``ShuffleKept`` (shuffle.py), or a ``ShuffleFile`` whose
    table :func:`keep_tables` turns into a kept set.  The input list must
    classify as fasta or fastq (sniffers mirror sketch.cpp:68-161);
    quality/abundance thresholds apply only on the fastq path, as in the
    reference.  ``kw`` goes to DeviceSketcher (n_blocks, block, buf_cap,
    mesh).
    """
    from ..seqio import classify_list, read_list

    if classify_list(list_path) == "fasta":
        least_qual, least_num_kmer = 0, 1
    files = read_list(list_path)
    params = KssdParams(half_k=shuf.k, half_subk=shuf.subk,
                        drlevel=shuf.drlevel)
    kept = shuf.kept if isinstance(shuf, ShuffleKept) else shuf.shuffled_dim
    sk = DeviceSketcher(params, kept, device=device,
                        least_qual=least_qual, least_num_kmer=least_num_kmer,
                        threads=threads, **kw)
    return sk.sketch_files(files)
