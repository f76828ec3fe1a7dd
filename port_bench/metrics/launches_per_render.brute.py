"""Device kernels, memcpys and memsets the profiler saw over the traced
calls of the brute triangle route's render, per call: the split bounce
(the hit, then the torch scatter and respawn) and the torch tail."""

from port_bench.metric_lib import launches_per_call as read  # noqa: F401
