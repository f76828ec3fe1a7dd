"""Lanes whose path was alive when their bounce started (the port's
``persistent.live_lanes``: kernels B and B-multi's ``stats``, the torch
chain's masks) over the lanes the persistent scheduler swept
(``persistent.lanes_kernel`` above the floor, ``persistent.lanes_tail``
and ``persistent.lanes_tail_fused`` at or below it), summed over every
bounce of the traced calls, not sampled at the count reads.  None on a
program without the counters."""

from port_bench import spans

SWEPT = ("persistent.lanes_kernel", "persistent.lanes_tail",
         "persistent.lanes_tail_fused")


def read(s):
    log = spans.port_log()
    if not log:
        return None
    live = spans.counter(log, "persistent.live_lanes")
    swept = sum(spans.counter(log, name) for name in SWEPT)
    if live <= 0 or swept <= 0:
        return None
    return live / swept
