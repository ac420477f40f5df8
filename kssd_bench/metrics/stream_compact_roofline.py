"""``stream_compact_kernel``'s share of its roofline: the least time the
window's compaction needs (a keep bit read a base, each survivor's hash
and 32-bit position written and its window read once; bytes bound it)
over the kernel's summed device time in the trace.  Survivors are
counted by the reference on the cell's input."""

from kssd_bench import roofline
from kssd_bench.readers import kernel_roofline


def _work(rec):
    if "bases" not in rec.work or "survivors" not in rec.extras:
        return None
    s = rec.config["sizes"]
    wide = s["half_k"] - s["drlevel"] > 8
    return roofline.stream_compact_work(rec.work["bases"],
                                        rec.extras["survivors"],
                                        8 if wide else 4, 2 * s["half_k"])


def read(rec):
    return kernel_roofline(rec, "stream_compact", _work)
