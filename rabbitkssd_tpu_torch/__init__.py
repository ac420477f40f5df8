"""rabbitkssd_tpu_torch: the PyTorch/CUDA port of rabbitkssd_tpu.

The port runs the sketch -> alldist main path on one NVIDIA GPU.  Plain
device code is PyTorch; the keep test is a hand-written CUDA kernel
(``csrc/member.cu``).  Host code that the JAX package keeps jax-free
(params, formats, seqio, shuffle, oracle, native, setops, the CLI
parser) is imported from ``rabbitkssd_tpu``, never copied; nothing here
imports jax.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
