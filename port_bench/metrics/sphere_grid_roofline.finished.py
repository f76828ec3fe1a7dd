"""Kernel I's share of its roofline: the operations of the pair tests it
made, counted by the port (the sweep's ``sphere_grid.pair_tests`` from
kernel I's ``stats``, and pass A's ``sphere_grid.pass_a_tests``, the
schedule kernel's lanes x active globals), 24 f32 operations each at 67
TFLOP/s, over the device time of kernel I and its schedule kernel in the
traced calls.  It counts the tests the kernel made, as
``tri_grid_roofline.finished`` does for kernel D, not those the inputs
need; the schedule's byte bound (its rays, records and schedule rows) is
left out, so the share reads the operation bound alone.  None where a
counter or the device time is 0: a program without the counters."""

from port_bench import metric_lib, roofline, spans

SPHERE_GRID = ("kernel I (sphere grid)", "kernel I schedule (sphere grid)")


def read(s):
    log = spans.port_log()
    if not log or not s["trace"]:
        return None
    pairs = spans.counter(log, "sphere_grid.pair_tests")
    pass_a = spans.counter(log, "sphere_grid.pass_a_tests")
    ms = metric_lib.device_ms(s["trace"], SPHERE_GRID)
    if pairs <= 0 or pass_a <= 0 or ms <= 0:
        return None
    ops = (pairs + pass_a) * roofline.OPS_SPHERE_PAIR
    return 100.0 * ops / roofline.PEAK_F32 / (ms / 1e3)
