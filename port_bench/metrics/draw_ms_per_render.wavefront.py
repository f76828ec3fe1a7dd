"""Device ms of the draw hashes (int64 elementwise ops) per traced call."""

from port_bench.metric_lib import DRAWS, group_ms_per_call


def read(s):
    return group_ms_per_call(s, DRAWS)
