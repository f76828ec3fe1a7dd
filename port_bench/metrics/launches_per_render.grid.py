"""Device kernels, memcpys and memsets the profiler saw over the traced
calls of the sphere grid's render, per call: the split bounce's cost (a
hit, then the torch scatter and respawn, every bounce), which a fused grid
bounce would cut."""

from port_bench.metric_lib import launches_per_call as read  # noqa: F401
