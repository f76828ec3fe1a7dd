"""1 - device busy time per traced call (NCCL's kernels left out) / the
mean wall of an untraced call, mean over ranks (``metric_lib.idle_share``)."""

from port_bench.metric_lib import idle_share as read  # noqa: F401
