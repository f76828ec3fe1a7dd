"""Milliseconds in NCCL's kernels per call on the rank that spends the
least there: the collectives' own cost, with little waiting in it (the
rank that arrives last at each collective waits least)."""

from port_bench.metric_lib import collective_s_per_call


def read(s):
    per = collective_s_per_call(s)
    return min(per) * 1e3 if per else None
