"""Alive lanes over the lanes the persistent scheduler sweeps, summed over
its alive-count reads, from the port's counters."""

from port_bench import spans


def read(s):
    log = spans.port_log()
    return spans.lane_occupancy(log) if log else None
