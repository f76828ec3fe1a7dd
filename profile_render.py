"""Where a render's time goes on one NVIDIA card, by torch.profiler.

Renders a scene of the PyTorch port once to warm up, once under the
profiler (CPU and CUDA activities), and once more unprofiled, then prints
one JSON line: the walls, the device time summed by kernel group (the hand
kernels by name, sorts, gathers and scatters, copies, other torch ops), the
launch counts, the device-busy share of the profiled wall and the ten
kernels that took the most device time.  The card's name and power limit
come first.  ``key=value`` arguments after the size override RenderConfig
fields, to profile an opt-in route.

    python3 profile_render.py mesh20k 800 450 50
    python3 profile_render.py final 1200 800 100
    python3 profile_render.py final 1200 800 100 fuse_bounce=off
    python3 profile_render.py final 1200 800 100 scatter_backend=pallas
    python3 profile_render.py final 1200 800 4      # the wavefront scheduler
    python3 profile_render.py final 1200 800 100 accel=grid   # the sphere grid

Needs a CUDA card and nvcc (the kernels build on first use).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# Device kernels grouped by a substring of their name; the first match wins.
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


def group_of(name: str) -> str:
    for group, key in GROUPS:
        if key in name:
            return group
    return "other torch ops"


def overrides(pairs) -> dict:
    """``key=value`` strings -> RenderConfig fields, each value parsed as
    its field's default is typed."""
    import dataclasses

    from win32_raytracer_tpu_torch.config import RenderConfig

    defaults = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    out = {}
    for pair in pairs:
        key, sep, val = pair.partition("=")
        if not sep or key not in defaults:
            raise SystemExit(f"not a RenderConfig key=value: {pair!r}")
        kind = type(defaults[key])
        if kind is bool:
            out[key] = val.lower() in ("1", "true", "on", "yes")
        else:
            out[key] = kind(val)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene")
    ap.add_argument("width", type=int)
    ap.add_argument("height", type=int)
    ap.add_argument("samples", type=int)
    ap.add_argument("config", nargs="*", metavar="key=value",
                    help="RenderConfig overrides, e.g. fuse_bounce=off")
    args = ap.parse_args()
    knobs = overrides(args.config)
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this needs a CUDA card",
              file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from win32_raytracer_tpu_torch.api import render
    from win32_raytracer_tpu_torch.config import RenderConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples=args.samples, **knobs)
    warm = render(args.scene, cfg=cfg, device="cuda").duration_ms / 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = render(args.scene, cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = render(args.scene, cfg=cfg, device="cuda").duration_ms / 1e3

    groups, launches, kernels = {}, {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.device_time_total
        g = group_of(ev.name)
        groups[g] = groups.get(g, 0.0) + dev_us / 1e3
        launches[g] = launches.get(g, 0) + 1
        kernels.append((ev.name, dev_us / 1e3))
    top = {}
    for name, ms in kernels:
        top[name] = top.get(name, 0.0) + ms
    busy = sum(groups.values())
    print(json.dumps({
        "scene": args.scene, "width": args.width, "height": args.height,
        "samples": args.samples, "config": knobs, "card": card,
        "warm_wall_s": warm, "profiled_wall_s": wall, "unprofiled_wall_s": after,
        "image_mean": float(res.image.mean()),
        "device_ms": groups, "launches": launches, "device_busy_ms": busy,
        "busy_share_of_profiled_wall": busy / 1e3 / wall,
        "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:10]),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
