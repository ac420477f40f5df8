"""Bit-exact emulation of glibc's ``srand()``/``rand()`` (TYPE_3 PRNG).

The reference generates ``.shuf`` permutation files with Fisher-Yates
driven by glibc ``rand()`` (reference shuffle.cpp:87-104).  Byte-exact
``.shuf`` reproduction therefore requires emulating glibc's default
additive-feedback generator, not any other PRNG.

glibc (stdlib/random_r.c) TYPE_3 algorithm:

  state r[0..33]:
    r[0] = seed (seed 0 -> 1)
    r[i] = (16807 * r[i-1]) % 2147483647   for i in 1..30   (Schrage)
    r[i] = r[i-31]                          for i in 31..33
  then the generator is cycled 310 times before the first output.
  each step: r[n] = (r[n-31] + r[n-3]) mod 2**32 ; output r[n] >> 1.

The output stream is a linear recurrence over Z_2^32, so blocks of
outputs are generated with uint32 matrix-vector products (wrapping
arithmetic) instead of a Python-level loop.  The port's copy of
``rabbitkssd_tpu/glibc_rand.py``.
"""

from __future__ import annotations

import numpy as np


def _initial_state(seed: int) -> np.ndarray:
    seed = seed & 0xFFFFFFFF
    if seed == 0:
        seed = 1
    r = np.zeros(34, dtype=np.int64)
    # glibc seeds via the signed value of the word
    word = np.int32(np.uint32(seed))
    r[0] = word
    for i in range(1, 31):
        # Schrage with C (truncate-toward-zero) division semantics, in case
        # the int32 view of the seed is negative.
        v = int(r[i - 1])
        hi = v // 127773 if v >= 0 else -((-v) // 127773)
        lo = v - hi * 127773
        word = 16807 * lo - 2836 * hi
        if word < 0:
            word += 2147483647
        r[i] = word
    for i in range(31, 34):
        r[i] = r[i - 31]
    return r.astype(np.uint32)


class GlibcRand:
    """Stream of glibc ``rand()`` outputs for a given seed."""

    _BLOCK = 4096
    # Coefficient matrices for block generation, shared across instances.
    _coef_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def __init__(self, seed: int):
        r = _initial_state(seed)
        # Warm up: glibc discards the first 310 outputs (10 * r_ptr loops).
        # state vector = last 31 values (r[n-31..n-1]); outputs start at n=34.
        state = [int(x) for x in r]
        for _ in range(310):
            nxt = (state[-31] + state[-3]) & 0xFFFFFFFF
            state.append(nxt)
        self._state = np.array(state[-31:], dtype=np.uint32)
        self._buf = np.empty(0, dtype=np.int32)
        self._pos = 0

    @classmethod
    def _coefs(cls, block: int) -> tuple[np.ndarray, np.ndarray]:
        """(A, C): out_block = A @ state ; new_state = C @ state (mod 2^32).

        Coefficients are themselves computed by running the lag-31/lag-3
        recurrence on symbolic basis vectors.
        """
        if block in cls._coef_cache:
            return cls._coef_cache[block]
        # rows: coefficient vectors (length 31) of r[n] in terms of state
        rows = [np.eye(31, dtype=np.uint32)[i] for i in range(31)]
        out = np.empty((block, 31), dtype=np.uint32)
        for b in range(block):
            nxt = rows[-31] + rows[-3]  # uint32 wraps
            rows.append(nxt)
            out[b] = nxt
        new_state = np.stack(rows[-31:])
        cls._coef_cache[block] = (out, new_state)
        return out, new_state

    def _refill(self):
        A, C = self._coefs(self._BLOCK)
        # uint32 matmul wraps mod 2^32 (C semantics)
        with np.errstate(over="ignore"):
            vals = (A @ self._state).astype(np.uint32)
            self._state = (C @ self._state).astype(np.uint32)
        self._buf = (vals >> np.uint32(1)).astype(np.int32)
        self._pos = 0

    def next(self) -> int:
        if self._pos >= len(self._buf):
            self._refill()
        v = int(self._buf[self._pos])
        self._pos += 1
        return v

    def take(self, n: int) -> np.ndarray:
        """Next n outputs as an int32 array."""
        chunks = []
        remaining = n
        while remaining > 0:
            if self._pos >= len(self._buf):
                self._refill()
            avail = len(self._buf) - self._pos
            m = min(avail, remaining)
            chunks.append(self._buf[self._pos : self._pos + m])
            self._pos += m
            remaining -= m
        return np.concatenate(chunks) if len(chunks) != 1 else chunks[0]


def fisher_yates(arr: np.ndarray, seed: int) -> np.ndarray:
    """In-place glibc-rand Fisher-Yates, mirroring reference shuffle.cpp:87-104.

    for i = n-1 .. 1: j = rand() % (i+1); swap(arr[i], arr[j])
    """
    n = len(arr)
    if n > 2147483647:
        raise ValueError("array too long for glibc rand-based shuffle")
    rng = GlibcRand(seed)
    if n > 1:
        rand_vals = rng.take(n - 1).astype(np.int64)
        # j for i = n-1 down to 1
        ii = np.arange(n - 1, 0, -1, dtype=np.int64)
        js = (rand_vals % (ii + 1)).astype(np.int32)
        from .native import load_native

        lib = load_native()
        if lib is not None and arr.dtype == np.int32 and arr.flags["C_CONTIGUOUS"]:
            import ctypes

            lib.kssd_fisher_yates_apply(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_int64(n),
                np.ascontiguousarray(js).ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int32)
                ),
            )
        else:  # pure-Python fallback (identical semantics)
            a = arr
            for idx in range(n - 1):
                i = n - 1 - idx
                j = int(js[idx])
                a[i], a[j] = a[j], a[i]
    return arr


def shuffle_n(n: int, base: int = 0) -> np.ndarray:
    """shuffleN equivalent (reference shuffle.cpp:76-85): identity + FY(seed 23)."""
    arr = np.arange(base, base + n, dtype=np.int32)
    return fisher_yates(arr, 23)
