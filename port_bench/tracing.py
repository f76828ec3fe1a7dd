"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
whole render calls inside the window, reduced to a small summary that the
per-layer metrics (``metrics/``) read.

Device operations are grouped by a substring of their name, the first
match winning (a copy of ``profile_render.py``'s ``GROUPS``, with NCCL's
kernels added).  An idle gap of the device is named by the innermost host
operation of the main thread running at its middle.
"""

from __future__ import annotations

import time

COLLECTIVES = "collectives (NCCL)"
GROUPS = (
    ("kernel A (sphere hit)", "hit_kernel"),
    ("kernel B (fused bounce)", "bounce_kernel"),
    ("kernel B-multi (k fused bounces)", "bounce_multi_kernel"),
    ("kernel E (hit + sky)", "hit_sky_kernel"),
    ("kernel F (scatter + respawn)", "scatter_respawn_kernel"),
    ("kernel C (triangle brute)", "tri_kernel"),
    ("kernel D (triangle grid)", "tri_grid_kernel"),
    ("kernel D schedule (triangle grid)", "tri_grid_schedule_kernel"),
    ("kernel G (sphere hit, columns)", "hit_cols_kernel"),
    ("kernel H (triangle hit, columns)", "tri_cols_kernel"),
    ("kernel I (sphere grid)", "hit_grid_kernel"),
    ("kernel I schedule (sphere grid)", "hit_grid_schedule_kernel"),
    (COLLECTIVES, "nccl"),
    ("sort", "sort"),
    ("sort", "Radix"),
    ("gather/scatter/index", "index"),
    ("gather/scatter/index", "gather"),
    ("gather/scatter/index", "scatter"),
    ("copy", "copy"),
    ("copy", "Memcpy"),
    ("copy", "Memset"),
    # Elementwise int64 ops: the counter-based draws (threefry on the
    # wavefront, hash_uniform01 on the persistent scheduler).
    ("int64 ops (draw hashes)", "long"),
)
OTHER = "other torch ops"


def group_of(name: str) -> str:
    for group, key in GROUPS:
        if key in name:
            return group
    return OTHER


class Slice:
    """Profiles the calls between :meth:`start` and :meth:`stop` on the
    current card; :meth:`summary` reduces what it saw."""

    def __init__(self, on_card: bool = True):
        self.on_card = on_card
        self.prof = None
        self.wall_s = 0.0

    def _sync(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def summary(self, calls: int) -> dict:
        """Device ms and launches by group, busy and window seconds, idle
        gaps by host operation (seconds), for ``calls`` traced calls.  The
        host operations are those of the busiest host thread."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], {}
        for ev in self.prof.events():
            tr = ev.time_range
            if ev.device_type == cuda:
                dev.append((tr.start, tr.end, ev.name))
            else:
                host.setdefault(ev.thread, []).append((tr.start, tr.end, ev.name))
        main = max(host.values(), key=len) if host else []
        return reduce_events(dev, main, calls, self.wall_s)


def reduce_events(dev, host, calls: int, wall_s: float) -> dict:
    """The summary of device intervals ``dev`` and host intervals ``host``
    ((start us, end us, name) each) over a slice of ``wall_s`` seconds."""
    ms, launches = {}, {}
    for s, e, name in dev:
        g = group_of(name)
        ms[g] = ms.get(g, 0.0) + (e - s) / 1e3
        launches[g] = launches.get(g, 0) + 1
    merged = _union(dev)
    busy_us = sum(e - s for s, e in merged)
    # NCCL's kernels overlap one another and spin while a rank waits for
    # the others: their union is the rank's time in collectives, and the
    # union of the other operations its compute.
    nccl = [d for d in dev if group_of(d[2]) == COLLECTIVES]
    rest = [d for d in dev if group_of(d[2]) != COLLECTIVES]
    gaps = {}
    mids = [((a[1] + b[0]) / 2, b[0] - a[1]) for a, b in zip(merged, merged[1:])]
    for (mid, length), name in zip(mids, _innermost(host, [m for m, _ in mids])):
        gaps[name] = gaps.get(name, 0.0) + length / 1e6
    return {
        "calls": calls,
        "wall_s": wall_s,
        "busy_s": busy_us / 1e6,
        "compute_busy_s": sum(e - s for s, e in _union(rest)) / 1e6,
        "collective_s": sum(e - s for s, e in _union(nccl)) / 1e6,
        "device_ms": ms,
        "launches": launches,
        "idle_gaps_s": gaps,
    }


def _union(intervals):
    """The disjoint [start, end] spans covered by ``intervals``, ascending."""
    merged = []
    for s, e, *_ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host, points):
    """For each point (ascending), the name of the innermost host interval
    covering it, or "host, no operation".  Host intervals of one thread
    nest, so a stack swept along them holds the chain covering a point."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, j = [], [], 0
    for p in points:
        while j < len(host) and host[j][0] <= p:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else "host, no operation")
    return out


def merge_ranks(summaries) -> dict:
    """One summary of several ranks' slices: device ms, launches and gaps
    of the rank with the most device time, busy seconds averaged, and
    ``per_rank`` kept for metrics that compare ranks."""
    lead = max(summaries, key=lambda s: s["busy_s"])
    out = dict(lead)
    out["busy_s"] = sum(s["busy_s"] for s in summaries) / len(summaries)
    out["per_rank"] = summaries
    return out


def breakdown(s: dict) -> dict:
    """The ten device groups and the ten idle causes that took longest."""
    ops = sorted(((g, v / 1e3) for g, v in s["device_ms"].items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(s["idle_gaps_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[g, v] for g, v in ops],
            "idle_gaps": [[g, v] for g, v in gaps]}
