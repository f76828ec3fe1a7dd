"""The end-to-end metrics over a window of synthetic timings, the trace
reduction and the roofline arithmetic."""

from __future__ import annotations

import numpy as np
import pytest

from port_bench import cells, roofline, tracing
from port_bench.scenes import final


def _summary(walls, rays=1_000_000):
    return {"walls": walls, "rays_per_call": rays, "setup_s": 9.0,
            "peak_alloc_bytes": 3 * 2 ** 30, "host_reads": 40, "trace": None,
            "cell": {}, "arrays": None}


def test_rate_is_over_the_window():
    walls = [(i * 0.5, i * 0.5 + 0.5) for i in range(10)]     # 10 calls, 5 s
    assert cells.metric("mrays_per_s")(_summary(walls)) == pytest.approx(2.0)


def test_rate_counts_a_stall():
    walls = [(0.0, 0.5), (0.5, 1.0), (1.0, 4.0), (4.0, 4.5)]  # one 3 s call
    assert cells.metric("mrays_per_s")(_summary(walls)) == pytest.approx(4 / 4.5)


def test_p95_over_all_calls():
    walls, t = [], 0.0
    for i in range(200):
        d = 0.1 if i % 20 else 0.3          # every 20th call slow: 10 of 200
        walls.append((t, t + d))
        t += d
    got = cells.metric("render_ms_p95")(_summary(walls))
    assert got == pytest.approx(np.percentile([b - a for a, b in walls], 95) * 1e3)
    assert 100.0 <= got <= 300.0


def test_p95_sees_one_stall_in_twenty():
    walls = [(i * 0.1, i * 0.1 + 0.1) for i in range(19)] + [(1.9, 2.9)]
    assert cells.metric("render_ms_p95")(_summary(walls)) > 100.0


def test_peak_and_setup():
    s = _summary([(0.0, 1.0)])
    assert cells.metric("peak_mem_gib")(s) == pytest.approx(3.0)
    assert cells.metric("setup_s")(s) == 9.0
    assert cells.metric("host_reads_per_render.persistent")(s) == 40


def test_trace_reduction():
    dev = [(0, 10, "void bounce_kernel<2>(...)"), (5, 12, "Memcpy DtoH"),
           (20, 30, "elementwise_kernel<long>"), (40, 45, "ncclDevKernel_AllGather")]
    host = [(0, 100, "render"), (11, 19, "aten::item"),
            (13, 14, "cudaStreamSynchronize"), (31, 39, "aten::add")]
    s = tracing.reduce_events(dev, host, 2, 1e-4)
    assert s["busy_s"] == pytest.approx(27e-6)
    assert s["launches"] == {"kernel B (fused bounce)": 1, "copy": 1,
                             "int64 ops (draw hashes)": 1, "collectives (NCCL)": 1}
    # The gap 12-20 has its middle, 16, in aten::item; 30-40 in aten::add.
    assert s["idle_gaps_s"] == {"aten::item": pytest.approx(8e-6),
                                "aten::add": pytest.approx(10e-6)}
    # NCCL's 5 us apart from the 22 us of compute.
    assert s["compute_busy_s"] == pytest.approx(22e-6)
    assert s["collective_s"] == pytest.approx(5e-6)
    other = dict(s, busy_s=s["busy_s"] / 2, compute_busy_s=11e-6,
                 collective_s=9e-6)
    merged = tracing.merge_ranks([s, other])
    assert merged["busy_s"] == pytest.approx(0.75 * 27e-6)
    # Calls 1 and 2 traced; calls 0 and 3 untraced, 100 us each.
    walls = [(0, 1e-4), (1e-4, 9e-4), (9e-4, 1.7e-3), (1.7e-3, 1.8e-3)]
    summ = {"trace": merged, "walls": walls, "rays_per_call": 1,
            "cell": {"trace": {"skip": 1, "calls": 2}}}
    assert cells.metric("device_idle.finished")(summ) == pytest.approx(
        1 - (22e-6 + 11e-6) / 2 / 2 / 1e-4)
    assert cells.metric("collective_ms_per_call")(summ) == pytest.approx(0.005 / 2)
    assert cells.metric("collective_skew_ms_per_call")(summ) == pytest.approx(
        0.004 / 2)
    assert cells.metric("launches_per_render.persistent")(summ) == 2.0
    b = tracing.breakdown(merged)
    assert b["device_ops"][0][0] in ("kernel B (fused bounce)",
                                     "int64 ops (draw hashes)")
    assert len(b["idle_gaps"]) == 2


def test_overlapping_collectives_count_once():
    """Two NCCL kernels that overlap on a rank count their union, not
    their sum, and leave the compute's union alone."""
    dev = [(0, 100, "ncclDevKernel_AllGather"), (50, 150, "ncclKernel_Bcast"),
           (120, 130, "void bounce_kernel<2>(...)")]
    s = tracing.reduce_events(dev, [], 1, 1e-3)
    assert s["collective_s"] == pytest.approx(150e-6)
    assert s["compute_busy_s"] == pytest.approx(10e-6)
    assert s["busy_s"] == pytest.approx(150e-6)


def test_idle_needs_an_untraced_call():
    s = tracing.reduce_events([(0, 10, "hit_kernel")], [], 1, 1e-4)
    summ = {"trace": tracing.merge_ranks([s]), "walls": [(0, 1e-4)],
            "cell": {"trace": {"skip": 0, "calls": 1}}}
    assert cells.metric("device_idle.finished")(summ) is None
    assert cells.metric("collective_ms_per_call")(summ) is None


def test_group_names_do_not_overlap():
    assert tracing.group_of("hit_sky_kernel<2>") == "kernel E (hit + sky)"
    assert tracing.group_of("bounce_multi_kernel") == "kernel B-multi (k fused bounces)"
    assert tracing.group_of("tri_grid_schedule_kernel") == "kernel D schedule (triangle grid)"
    assert tracing.group_of("hit_kernel<1>") == "kernel A (sphere hit)"


def test_sphere_roofline_counts_the_inputs():
    spheres = final.build()["spheres"]
    assert roofline.sphere_ops(spheres) == 488 * 24
    b = roofline.sphere_sweep_bound_s(96e6, 2.0, spheres)
    assert b == pytest.approx(96e6 * 2.0 * 488 * 24 / 67e12)
    s = {"trace": {"calls": 1, "device_ms": {"kernel B (fused bounce)": b * 2e3}},
         "cell": {"segments_per_primary": {"mean": 2.0}},
         "rays_per_call": 96e6, "arrays": {"spheres": spheres}}
    assert cells.metric("sphere_sweep_roofline.finished")(s) == pytest.approx(50.0)
    assert cells.metric("sphere_sweep_roofline.preview")(s) is None
