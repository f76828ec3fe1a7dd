"""Kernel D's share of its roofline: the operations of the pair tests and
any-touch tests it counted (the port's counters) at 67 TFLOP/s, over the
device time of kernel D and its schedule kernel (the device trace)."""

from port_bench import spans


def read(s):
    log = spans.port_log()
    return spans.tri_grid_roofline_pct(log, s["trace"]) if log else None
