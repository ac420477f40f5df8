"""Percent of the stream step's consumer thread's loop that it spent on
a CPU: its CPU seconds over the whole loop (budget ``consumer_cpu``,
``time.thread_time()`` read at the loop's ends) over the seconds it
issued steps (``dispatch``) and waited for batches (``qwait``), which
are the loop's wall less its flush hand-offs.  It does not tell the
step's work from waits that cost CPU time (for the producer or the
interpreter lock): low when the thread sleeps, near 100 when it runs."""

from kssd_bench.parts import budget_ratio


def read(rec):
    return budget_ratio(rec, "consumer_cpu", "dispatch", "qwait",
                        scale=100.0)
