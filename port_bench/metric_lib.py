"""Arithmetic the metric readers (``metrics/<name>.py``) share.  A reader
takes the run's summary and returns a number, or None where it finds
nothing to read (the metric is then left out of the line).

The summary: ``walls`` [(start s, end s)] of the window's calls,
``rays_per_call``, ``setup_s``, ``peak_alloc_bytes`` (largest rank),
``host_reads`` (the port's ``persistent.HOST_READS`` over the window),
``cell`` (the workload file), ``arrays`` (the scene's arrays) and, in a
traced run, ``trace`` (``tracing.merge_ranks`` of the ranks' slices).
"""

from __future__ import annotations

from port_bench import roofline

SPHERE_SWEEPS = ("kernel A (sphere hit)", "kernel B (fused bounce)",
                 "kernel B-multi (k fused bounces)", "kernel E (hit + sky)")
SPHERE_COLUMNS = ("kernel G (sphere hit, columns)",)
TRI_GRID = ("kernel D (triangle grid)", "kernel D schedule (triangle grid)")
DRAWS = ("int64 ops (draw hashes)",)


def device_ms(trace: dict, groups) -> float:
    return sum(trace["device_ms"].get(g, 0.0) for g in groups)


def launches_per_call(s: dict):
    t = s["trace"]
    if not t or not t["launches"]:
        return None
    return sum(t["launches"].values()) / t["calls"]


def group_ms_per_call(s: dict, groups):
    t = s["trace"]
    if not t:
        return None
    ms = device_ms(t, groups)
    return ms / t["calls"] if ms > 0 else None


def sphere_roofline_pct(s: dict, groups):
    """100 x bound / device time of the sphere sweeps in the slice."""
    t = s["trace"]
    seg = s["cell"].get("segments_per_primary")
    if not t or not seg:
        return None
    ms = device_ms(t, groups)
    if ms <= 0:
        return None
    primary = s["rays_per_call"] * t["calls"]
    bound = roofline.sphere_sweep_bound_s(primary, seg["mean"],
                                          s["arrays"]["spheres"])
    return 100.0 * bound / (ms / 1e3)


def untraced_call_s(s: dict):
    """The mean wall of the window's calls that ran outside the traced
    slice, or None where there are none.  The profiler records every host
    operation and slows the host-bound calls it traces, so a traced call's
    wall is no measure of the card's idle time."""
    tr = s["cell"].get("trace", {"skip": 1, "calls": 1})
    skip, n = int(tr["skip"]), int(tr["calls"])
    walls = [b - a for i, (a, b) in enumerate(s["walls"])
             if not skip <= i < skip + n]
    return sum(walls) / len(walls) if walls else None


def idle_share(s: dict):
    """1 - device busy seconds per traced call / the mean wall of an
    untraced call, averaged over ranks.  Busy is the union of the device's
    operations other than NCCL's kernels, which spin while a rank waits."""
    t = s["trace"]
    call_s = untraced_call_s(s) if t else None
    if not call_s or t["busy_s"] <= 0:
        return None
    ranks = t["per_rank"]
    return sum(1 - r["compute_busy_s"] / r["calls"] / call_s
               for r in ranks) / len(ranks)


def collective_s_per_call(s: dict):
    """Each rank's seconds in NCCL's kernels (their union) per traced call,
    or None where there are none."""
    t = s["trace"]
    if not t:
        return None
    per = [r["collective_s"] / r["calls"] for r in t["per_rank"]]
    return per if max(per) > 0 else None
