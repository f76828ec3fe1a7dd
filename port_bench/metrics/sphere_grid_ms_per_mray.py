"""Device ms of kernel I and its schedule kernel per million primary rays
traced."""

from port_bench.metric_lib import device_ms

SPHERE_GRID = ("kernel I (sphere grid)", "kernel I schedule (sphere grid)")


def read(s):
    t = s["trace"]
    if not t:
        return None
    ms = device_ms(t, SPHERE_GRID)
    return ms / (s["rays_per_call"] * t["calls"] / 1e6) if ms > 0 else None
