"""Host-side helpers the port shares with the JAX package, in one place.

These modules of ``rabbitkssd_tpu`` load without jax (the port's own
modules import them too): shuffle files, sketch files, the FASTA/FASTQ
reader, the native host library and the numpy oracle.  Scripts that
drive the port, such as ``chip_smoke.py``, import them from here so that
they name no module of the JAX package.
"""

from rabbitkssd_tpu.formats import read_sketches
from rabbitkssd_tpu.native import load_native
from rabbitkssd_tpu.oracle import oracle_hashes_numpy
from rabbitkssd_tpu.params import KssdParams
from rabbitkssd_tpu.seqio import read_records
from rabbitkssd_tpu.shuffle import (generate_shuffle, read_shuffle_file,
                                    write_shuffle_file)

__all__ = ["KssdParams", "generate_shuffle", "load_native",
           "oracle_hashes_numpy", "read_records", "read_shuffle_file",
           "read_sketches", "write_shuffle_file"]
