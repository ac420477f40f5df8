"""``stream_keep_kernel``'s share of its roofline: the least time the
window's keep tests need (26 32-bit operations a base fed, each base
read at 2 bits and a keep bit written; operations bound it) over the
kernel's summed device time in the trace."""

from kssd_bench import roofline
from kssd_bench.readers import kernel_roofline


def read(rec):
    return kernel_roofline(
        rec, "stream_keep",
        lambda r: (roofline.stream_keep_work(r.work["bases"])
                   if "bases" in r.work else None))
