"""Device ms of kernel D and its schedule kernel per million primary
rays traced."""

from port_bench.metric_lib import TRI_GRID, device_ms


def read(s):
    t = s["trace"]
    if not t:
        return None
    ms = device_ms(t, TRI_GRID)
    return ms / (s["rays_per_call"] * t["calls"] / 1e6) if ms > 0 else None
