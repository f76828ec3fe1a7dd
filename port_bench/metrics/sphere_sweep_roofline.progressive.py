"""Share (%) of the sphere sweeps' least time (roofline.py, counted from
the inputs with the cell's ``segments_per_primary``) in the device time of
kernels A, B, B-multi and E: in ``final4k_rr.progressive``, kernel B's and
B-multi's roulette-and-strata form."""

from port_bench.metric_lib import SPHERE_SWEEPS, sphere_roofline_pct


def read(s):
    return sphere_roofline_pct(s, SPHERE_SWEEPS)
