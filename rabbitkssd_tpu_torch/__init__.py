"""rabbitkssd_tpu_torch: the PyTorch/CUDA port of rabbitkssd_tpu.

The port runs every subcommand on one NVIDIA GPU or on several ranks.
Plain device code is PyTorch; the stream step's window hash + keep test
and its compaction + append are hand-written CUDA kernels
(``csrc/stream_keep.cu``, ``csrc/stream_compact.cu``), beside the
stand-alone bitmap keep test (``csrc/member.cu``).  The port imports
nothing of ``rabbitkssd_tpu`` and no jax: the jax-free host modules it
needs (params, formats, seqio, shuffle, glibc_rand, oracle, native,
engine.setops, utils.stdheap, the CLI parser and host-only commands)
are copies under the same module names.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
