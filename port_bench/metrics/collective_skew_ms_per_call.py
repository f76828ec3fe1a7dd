"""Milliseconds in NCCL's kernels per call, the rank that spends the most
there less the rank that spends the least: how long ranks wait for one
another at the collectives (the lockstep's skew)."""

from port_bench.metric_lib import collective_s_per_call


def read(s):
    per = collective_s_per_call(s)
    return (max(per) - min(per)) * 1e3 if per else None
