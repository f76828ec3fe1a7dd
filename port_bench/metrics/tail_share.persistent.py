"""Share of the persistent scheduler's host time spent in the torch tail
below the 2^19-lane floor (its bounces, and the count reads, compactions
and one-shot tails that run there), from the port's spans."""

from port_bench import spans


def read(s):
    log = spans.port_log()
    return spans.tail_share(log) if log else None
