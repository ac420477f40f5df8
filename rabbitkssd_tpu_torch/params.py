"""Kssd sketch parameters and derived bit masks.

Re-design of the reference parameter engine (reference common.h:8-25,
common.cpp:35-78); the port's copy of ``rabbitkssd_tpu/params.py``.

A k-mer of ``2*half_k`` bases is encoded as a ``4*half_k``-bit integer
(2 bits per base).  The *substring space* is the middle ``2*half_subk``
bases (``4*half_subk`` bits); its value ("dim id") is looked up in a
shuffled permutation table and the k-mer is kept iff the permuted rank is
below ``dim_end = 16**(half_subk - drlevel)`` — an exact ``16**-drlevel``
sampling of the substring space.  The surviving k-mer is re-packed into a
``4*(half_k - drlevel)``-bit hash composed of the outer-context bits and
the permuted rank.
"""

from __future__ import annotations

import dataclasses

MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class KssdParams:
    """Derived constants for sketching. Mirrors kssd_parameter_t

    (reference common.h:8-25), derivation mirrors initParameter()
    (reference common.cpp:35-78) bit-for-bit.
    """

    half_k: int
    half_subk: int
    drlevel: int

    # derived (filled in __post_init__)
    half_outctx_len: int = dataclasses.field(init=False)
    rev_add_move: int = dataclasses.field(init=False)
    kmer_size: int = dataclasses.field(init=False)
    dim_start: int = dataclasses.field(init=False)
    dim_end: int = dataclasses.field(init=False)
    tupmask: int = dataclasses.field(init=False)
    domask: int = dataclasses.field(init=False)
    undomask0: int = dataclasses.field(init=False)
    undomask1: int = dataclasses.field(init=False)

    def __post_init__(self):
        if self.half_subk - self.drlevel < 3:
            raise ValueError(
                "half_subk - drlevel must be at least 3 "
                f"(got half_subk={self.half_subk}, drlevel={self.drlevel})"
            )
        if self.half_k < self.half_subk:
            raise ValueError("half_k must be >= half_subk")
        if 4 * self.half_k > 64:
            raise ValueError("half_k too large: 4*half_k must fit in 64 bits")
        object.__setattr__(self, "half_outctx_len", self.half_k - self.half_subk)
        object.__setattr__(self, "rev_add_move", 4 * self.half_k - 2)
        object.__setattr__(self, "kmer_size", 2 * self.half_k)
        object.__setattr__(self, "dim_start", 0)
        object.__setattr__(self, "dim_end", 1 << (4 * (self.half_subk - self.drlevel)))
        comp_bittl = 64 - 4 * self.half_k
        tupmask = MASK64 >> comp_bittl
        hoc = self.half_outctx_len
        domask = ((tupmask >> (4 * hoc)) << (2 * hoc)) & MASK64
        undomask = (tupmask ^ domask) & tupmask
        undomask1 = undomask & (tupmask >> ((self.half_k + self.half_subk) * 2))
        undomask0 = undomask ^ undomask1
        object.__setattr__(self, "tupmask", tupmask)
        object.__setattr__(self, "domask", domask)
        object.__setattr__(self, "undomask0", undomask0)
        object.__setattr__(self, "undomask1", undomask1)

    # ---- identity / compatibility -------------------------------------
    @property
    def sketch_id(self) -> int:
        """Persisted compat id: (half_k<<8)|(half_subk<<4)|drlevel.

        Reference sketch.cpp:1029, shuffle.cpp:50.
        """
        return (self.half_k << 8) + (self.half_subk << 4) + self.drlevel

    @property
    def use64(self) -> bool:
        """Hash width > 32 bits. Reference rule at sketch.cpp:336."""
        return self.half_k - self.drlevel > 8

    @property
    def hash_bits(self) -> int:
        """Width of the reduced hash in bits: 4*(half_k-drlevel)."""
        return 4 * (self.half_k - self.drlevel)

    @property
    def hash_space(self) -> int:
        """Number of possible reduced-hash values: 16**(half_k-drlevel)."""
        return 1 << self.hash_bits

    @property
    def dim_size(self) -> int:
        """Size of the substring (context) space: 16**half_subk."""
        return 1 << (4 * self.half_subk)

    # amount undomask1 is shifted left in the hash composition:
    # kmer_size*2 - half_outctx_len*4 == 4*half_subk  (sketch.cpp:224)
    @property
    def undomask1_shift(self) -> int:
        return self.kmer_size * 2 - self.half_outctx_len * 4


def params_from_id(sketch_id: int) -> KssdParams:
    """Invert the (half_k<<8)|(half_subk<<4)|drlevel packing."""
    return KssdParams(
        half_k=sketch_id >> 8,
        half_subk=(sketch_id >> 4) & 0xF,
        drlevel=sketch_id & 0xF,
    )


# 2-bit base encoding. Mirrors BaseMap (reference common.h:27-37):
# A/a=0, C/c=1, G/g=2, T/t=3, everything else invalid (-1).
BASE_MAP = [-1] * 128
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    BASE_MAP[ord(_ch)] = _v
    BASE_MAP[ord(_ch.lower())] = _v
