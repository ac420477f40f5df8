"""Exact emulation of libstdc++ ``std::priority_queue``.

The reference's top-N neighbor output (reference dist.cpp:
599,633-639,683-689) emits rows by repeatedly popping a
``std::priority_queue<DistInfo, vector, cmpDistInfo>``.  The *order* of
equal-keyed elements is determined by libstdc++'s exact sift algorithms
(bits/stl_heap.h: ``__push_heap`` / ``__adjust_heap``), so byte-identical
output requires replicating them — Python's ``heapq`` will not do.

``comp(a, b)`` must implement the C++ comparator (strict weak "less").
The port's copy of ``rabbitkssd_tpu/utils/stdheap.py``.
"""

from __future__ import annotations

from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class StdPriorityQueue(Generic[T]):
    """std::priority_queue with libstdc++ heap semantics (max-heap)."""

    def __init__(self, comp: Callable[[T, T], bool]):
        self._v: list[T] = []
        self._comp = comp

    def __len__(self) -> int:
        return len(self._v)

    def top(self) -> T:
        return self._v[0]

    def push(self, value: T) -> None:
        self._v.append(value)
        self._push_heap(len(self._v) - 1, 0, value)

    def pop(self) -> T:
        """pop_heap + pop_back; returns the removed top element."""
        v = self._v
        result = v[0]
        value = v[-1]
        if len(v) > 1:
            # std::__pop_heap: move last to hole at 0, adjust with value
            v[-1] = v[0]
            self._adjust_heap(0, len(v) - 1, value)
        v.pop()
        return result

    # -- bits/stl_heap.h ----------------------------------------------------
    def _push_heap(self, hole: int, top: int, value: T) -> None:
        v, comp = self._v, self._comp
        parent = (hole - 1) // 2
        while hole > top and comp(v[parent], value):
            v[hole] = v[parent]
            hole = parent
            parent = (hole - 1) // 2
        v[hole] = value

    def _adjust_heap(self, hole: int, length: int, value: T) -> None:
        v, comp = self._v, self._comp
        top = hole
        second = hole
        while second < (length - 1) // 2:
            second = 2 * (second + 1)
            if comp(v[second], v[second - 1]):
                second -= 1
            v[hole] = v[second]
            hole = second
        if (length & 1) == 0 and second == (length - 2) // 2:
            second = 2 * (second + 1)
            v[hole] = v[second - 1]
            hole = second - 1
        self._push_heap(hole, top, value)
