"""The ``.sketch`` file (RabbitKSSD sketch.cpp:1024-1154), read: five
int32 (id, half_k, half_subk, drlevel, genome count), the genomes' name
lengths (int32) and hash counts (int32), then each
genome's name bytes and its hashes (uint32, or uint64 when
half_k - drlevel > 8)."""

from __future__ import annotations

import struct

import numpy as np


def _dtype(half_k: int, drlevel: int) -> np.dtype:
    return np.dtype("<u8") if half_k - drlevel > 8 else np.dtype("<u4")


def read(path: str) -> tuple[tuple[int, ...], list[str], list[np.ndarray]]:
    """((id, half_k, half_subk, drlevel, count), names, hashes)."""
    with open(path, "rb") as f:
        data = f.read()
    head = struct.unpack_from("<5i", data, 0)
    n = head[4]
    name_len = np.frombuffer(data, "<i4", n, 20)
    hash_len = np.frombuffer(data, "<i4", n, 20 + 4 * n)
    dt = _dtype(head[1], head[3])
    pos = 20 + 8 * n
    names, hashes = [], []
    for i in range(n):
        names.append(data[pos: pos + int(name_len[i])].decode())
        pos += int(name_len[i])
        hashes.append(np.frombuffer(data, dt, int(hash_len[i]), pos))
        pos += int(hash_len[i]) * dt.itemsize
    if pos != len(data):
        raise ValueError(f"{path}: {len(data) - pos} bytes after the last "
                         "genome")
    return head, names, hashes
