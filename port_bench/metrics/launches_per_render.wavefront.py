"""Device kernels, memcpys and memsets the profiler saw over the traced
calls, per call."""

from port_bench.metric_lib import launches_per_call as read  # noqa: F401
