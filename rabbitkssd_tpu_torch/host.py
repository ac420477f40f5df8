"""Host-side helpers that scripts driving the port need, in one place.

Shuffle files, sketch files, the FASTA/FASTQ reader, the native host
library and the numpy oracle: the port's own copies of the JAX
package's jax-free modules (the port imports nothing of
``rabbitkssd_tpu``).  Scripts such as ``chip_smoke.py`` import them
from here.
"""

from .formats import read_sketches
from .native import load_native
from .oracle import oracle_hashes_numpy
from .params import KssdParams
from .seqio import read_records
from .shuffle import generate_shuffle, read_shuffle_file, write_shuffle_file

__all__ = ["KssdParams", "generate_shuffle", "load_native",
           "oracle_hashes_numpy", "read_records", "read_shuffle_file",
           "read_sketches", "write_shuffle_file"]
