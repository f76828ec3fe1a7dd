"""Share (%) of the sphere sweeps' least time (roofline.py, counted from
the inputs) in the device time of kernel G."""

from port_bench.metric_lib import SPHERE_COLUMNS, sphere_roofline_pct


def read(s):
    return sphere_roofline_pct(s, SPHERE_COLUMNS)
