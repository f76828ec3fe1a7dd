"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the hand-written kernels from win32_raytracer_tpu_torch/csrc, holds
each against its plain torch version on the card (on random inputs, and on
the inputs its main path hands it at its own shapes), renders small images
through both paths, then drives the main paths through the kernels and
checks that each kernel of a path ran in it:

* phases 2-5: the headline (the RTIOW final scene at 1200x800, 100 spp;
  kernel B, and below the floor kernels B-multi and B, or kernels A and B
  under ``multi_backend="xla"``), each kernel held exactly to its plain
  version, kernel A at one and at two rays per thread, on
  random inputs, on tables with exact ties, inactive rows and mixed
  shutter intervals, and on the headline's own bounces; kernel A timed at
  the batch sizes the headline's torch-chain tail launches;
* phase 6: kernel C (brute triangle sweep) against its plain version,
  bit for bit in each launch form, on the ``mesh`` table and its variants
  (inactive, copied and NaN rows, six stages), on boundary pairs of the
  exact pair test and on a ``mesh`` render's bounce rays;
* phase 7: kernel D (Morton-tile grid sweep: its schedule kernel, then the
  sweep) against its plain version and against kernel C, at BASELINE
  config 4's chunk, the schedule kernel against the torch prelude; then on
  a grid of 61,440 tiles (491,520 triangles in tiles of 8 rows);
* phase 8: mesh and mesh20k renders, kernels against plain, then
  ``render("mesh")`` (kernels A, C and F) and config 4, ``render("mesh20k")``
  at 800x450, 50 spp (kernels A, D and F);
* phase 9: kernels E (hit + sky; one and two lanes a thread) and F
  (scatter + respawn) against their plain versions, and E then F against
  kernel B on the headline's chunk;
* phase 10: kernel B's k-bounce variant against four launches of kernel B
  and its plain version;
* phase 11: the headline once per route (the default, ``fuse_bounce="off"``,
  ``scatter_backend="pallas"``, ``hit_kernel="v4"``, ``multi_backend``
  "xla" and "fused"), the default byte-equal to "xla", and config 4 with
  the pallas scatter; then the split route's kernel F at every size:
  ``final`` under ``accel="grid"``, ``mesh`` and ``mesh20k``, small and at
  their cells' sizes on one seed, by default and under
  ``scatter_backend="jnp"``: linear images bit-equal, kernel F once a
  split bounce, the torch draws at each batch's first respawn only, the
  device launches a render and the walls of both;
* phase 12: BASELINE config 5, an 8-frame flythrough of the final scene at
  640x480, 32 spp, through ``render_animation`` (kernel B on 8 cameras);
* phase 13: kernels G (column sphere hit) and H (column triangle hit;
  both at one and two rays a thread) against their plain versions, on
  random rays, H also on phase 6's tables and boundary pairs and on
  ``mesh20k``'s table, and on the wavefront's own
  first and second bounce rays of ``final`` (1200x800, 4 spp) and ``mesh``
  (800x450, 4 spp);
* phase 14: the wavefront scheduler: small renders, kernels against plain;
  the threefry draw kernel bit-equal to the torch version on the card and
  on the CPU, and timed against its bound and the torch version at the
  preview's shape; ``render("final")`` at 1200x800, 4 spp (kernel G and
  the draw kernel) and with ``deterministic=True``, each equal to its
  plain render; ``render("mesh")`` at 800x450, 4 spp (kernels G and H and
  the draw kernel); and one CLI render in a subprocess;
* phase 15: kernel I (the sphere grid: its schedule kernel, pass A and the
  block schedule, then the sweep, pass B and the merge) against its plain
  grid sweep in rows and in columns, on random rays, a scene with inactive
  spheres and the headline's own bounce rays under ``accel="grid"``, and
  against kernel A (brute); grids of 257 and 1,000 globals (pass A over
  several stages) and a small grid render of each against its plain
  render; the experimental adapters (v1, v2 on kernel G, v5 on kernel A)
  against their plain versions;
* phase 16: the sphere grid through the entry points: small grid renders
  equal to their plain renders, the headline with ``accel="grid"``
  (kernel I's two launches and kernel F on every bounce), and an explicit
  ``hit_fn`` on the persistent scheduler;
* phase 17: kernels A, B and E timed alone at the headline's shapes, G at
  the wavefront's, the grid wrappers (D at config 4's chunk, I at the
  grid headline's second bounce), C at the ``mesh`` render's bounce-1
  rays and H at the wavefront ``mesh``'s, with the public entry points only, so
  that ``--root`` can point it at another checkout of the package (an
  earlier commit, for a side-by-side timing);
* phase 18: the persistent scheduler's opt-in knobs on the headline: the
  route compactor against the sort compactor on the headline's state at
  its first above-floor compaction (alive slots bit-equal, padding inert);
  the window flush and the run-sum flush against ``index_add_`` on the
  headline's dropped tails (sorted, argsorted, sparse) with TF32 matmuls
  allowed; ``p_render_until`` against stepped bounces on the staged
  tail's first stage; a receiver event's per-pixel sample accounting; and
  the headline under each of ``compactor="route"``, ``flush_mode=
  "window"``, ``one_shot`` "on" and "staged" and ``redistribute="on"``
  beside the default (mean, launches, median wall, host reads, time in
  compactions);
* phase 19: checkpoints on the card: two uninterrupted headlines
  bit-equal (and, for comparison, the same with ``index_add_`` as the
  flush), the headline resumed at pass level (4 passes) and at chunk
  level (4 row chunks), the wavefront's ``final`` 1200x800@4 resumed at
  pass level, each byte-identical to its uninterrupted render, and one
  CLI render with ``--checkpoint``;
* phase 20: the triangle grid's other arms and adaptive allocation.  At
  config 4, kernel D exact against its plain version on bounce 2's rays
  sorted by capped chord keys and on the DDA pair sets at K = 4 and 12,
  beside the unsorted and binned sets (its pair tests, any-touch tests,
  walk entries and ms on each); the sorted and DDA passes against the
  direct pass and their sort / expansion costs; config 4 under
  ``tri_rebin`` "on", "dda" (K = 4, 12), ``tri_sub_gate=2``, unbinned and
  the default (walls, launches, kernel D's pair tests; "on" bit-equal to
  unbinned, "dda" in the reference's envelope, the sub-gate bit-equal to
  the default).  The headline under ``adaptive_alloc="on"`` and with
  ``adaptive_pool="on"`` against the default (walls, launches, host
  reads), ``alloc_lanes``'s invariants exact on each chunk, two adaptive
  headlines bit-equal.
* phase 21: several devices (parallel/) on the one card: 2 ranks as 2
  processes sharing cuda:0 (gloo), so it checks the lane partition, the
  lockstep decisions and the reduce over ranks, and its walls are the
  sharded scheduler's overhead, not scaling.  Small sharded renders
  (``final``, ``test``, ``mesh`` at 160x120@16; persistent, rows and spp
  modes) bit-equal to their plain renders and to a second run, with each
  route's kernels, ``final`` and ``test`` also under
  ``multi_backend="xla"`` (bit-equal to the default, whose tail below the
  floor is kernels B-multi and B); the headline over the 2 ranks (mean,
  launches per rank, median wall of 3); ``multi_backend`` "xla" and
  "fused" against the default over the ranks (bit-equal, launches per
  rank); BASELINE config 5 through
  ``render_animation(mesh=, shard_mode="rows")``; a pass-level sharded
  checkpoint resumed byte-equal; the headline over 1 rank under NCCL;
  and what NCCL does with 2 ranks on one card (a subprocess).

Phase 1 prints each sweep kernel's registers, spills and shared memory
and, from ``cuobjdump -sass`` of the built library, the instruction mix
of each kernel's innermost sweep loops and a digest of every kernel's
code (so that two checkouts' builds can be compared kernel by kernel).

Each phase prints one line or more; any failure raises, so the exit code is
non-zero.  Before the last line, a ``{"kernels": [...]}`` line (each
kernel's launches on its main path, agreement, times and bound) and the
card's name and power limit; the last line is a JSON object naming the
device.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 0,1,6  # a subset (0 is always run)
    python3 chip_smoke.py --phases 0,1,13,14   # the wavefront slice
    python3 chip_smoke.py --phases 0,1,15,16   # the sphere grid slice
    python3 chip_smoke.py --phases 0,1,2,3,5,9,10,13,15   # the packed sweep
    python3 chip_smoke.py --phases 0,1,6,7,8,13,14,17   # the triangle sweeps
    python3 chip_smoke.py --phases 0,1,17 --root out/parent  # A-E, G, H, I of a checkout
    python3 chip_smoke.py --phases 0,1,18,19   # the scheduler's knobs and checkpoints
    python3 chip_smoke.py --phases 0,1,20      # the rebin / DDA arms and adaptive allocation
    python3 chip_smoke.py --phases 0,1,21      # several devices (ranks sharing the card)

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HEADLINE = dict(width=1200, height=800, samples=100)
RANDOM_RAYS = 1 << 18   # rays (lanes) of phases 2, 3, 6 and 13's random inputs
MANY_TILE_RAYS = 1 << 16    # phase 7's rays on the grid of 61,440 tiles
MANY_GLOBAL_RAYS = 1 << 18  # phase 15's rays on the grids of many globals
HEADLINE_MEAN = 170.1   # the JAX renderer's u8 image mean for this scene and size
HEADLINE_MEAN_TOL = 1.5
# Phase 19's chunk-level checkpoint: 983,040 rays a chunk give the headline
# 4 chunks of up to 204 rows.
HEADLINE_CHUNK_RAYS = 983040
CONFIG4 = dict(width=800, height=450, samples=50)   # BASELINE.json config 4
SMALL_MESH = dict(width=160, height=90, samples=8, seed=2)
# The wavefront's full-width render and its mesh render (phases 13-14).
WAVEFRONT = dict(width=1200, height=800, samples=4)
WAVEFRONT_MESH = dict(width=800, height=450, samples=4)
# The JAX renderer's u8 image mean for ``final`` at 300x200, 4 spp, seed 0
# (its wavefront scheduler, on the CPU; the port's plain path on the CPU
# reads 169.872).
WAVEFRONT_SMALL = dict(width=300, height=200, samples=4)
# The preview cell's lanes (port_bench final.preview: 640x480, 4 spp, one
# chunk), the shape of each of its draws with 5 a lane (phase 14).
PREVIEW_LANES = 640 * 480 * 4
WAVEFRONT_SMALL_MEAN = 169.874
WAVEFRONT_SMALL_TOL = 0.5

# The least time the card could take: the larger of the operations over
# the f32 rate outside the tensor cores and the bytes over the memory rate
# (NVIDIA's H100 SXM data sheet, at the full 700 W limit).
PEAK_F32 = 67e12        # FLOP/s
PEAK_BYTES = 3.35e12    # B/s
# 32-bit integer instructions: 132 SMs x 128 lanes (each of an SM's four
# schedulers issues one warp instruction a clock; integer adds and
# multiply-adds run on the FMA pipes beside the INT pipe's logic and
# shifts) x 1.98 GHz, the H100 SXM's boost clock.  The data sheet gives no
# integer rate outside the tensor cores.
PEAK_INT32 = 33.4e12    # op/s
# Integer operations per threefry uniform draw (csrc/draws.cu): 20 rounds
# of add, rotate and xor, 12 key adds, 3 for the output bits.
OPS_THREEFRY = 75
# f32 operations per pair test, counted from csrc/common.cuh: a sphere
# (sweep_packed) 23 multiplies, adds and subtractions and the
# discriminant's compare where its tile of 256 rows shares one (t1, invdt)
# and the lerp is formed once per ray and tile, 25 and the compare where
# it does not (sphere_ops; the root's five more where the ray meets the
# sphere are not counted); a triangle (tri_pair_t) 46 multiplies, adds,
# subtractions and the division, and 6 compares.
OPS_SPHERE_PAIR, OPS_SPHERE_PAIR_LERP = 24, 26
OPS_TRI_PAIR = 52
# Kernel D's any-touch test per lane and walk entry (csrc/tri_grid.cu
# any_touch): 6 subtractions, 6 multiplies, 12 min/max, a multiply, an add
# and the compare.  Its schedule kernel: per lane the scene-box clip and the
# segment's extremes (tri_accel.clip_segment_to_box and
# tri_block_schedule_rows: 6 subtractions, 6 divisions, 15 min/max, 12 for
# the segment ends, 5 for |d|^2, 13 folds), per block and tile the overlap
# and entry bound (6 compares, 18 for the gaps, a root, a division and 3
# clamps).  The sphere grid's schedule kernel: pass A's pair tests (24 each)
# and per lane the footprint (2 divisions, 4 subtractions, 8 min/max, 4
# multiplies, 4 adds, 4 folds).
OPS_ANY_TOUCH = 27
OPS_TRI_CLIP = 57
OPS_TRI_TLO = 29
OPS_FOOTPRINT = 26
# The library is built with --fmad=false, so every multiply and add of a
# pair test issues alone: the f32 pipes retire 67e12 / 2 of them a second,
# and a sweep's floor under --fmad=false is twice its bound.
PEAK_F32_UNFUSED = PEAK_F32 / 2
# Kernel F's f32 operations, an upper count from csrc/common.cuh: scatter
# and roulette ~200 per live lane (each transcendental call as one), draws
# and respawn ~60 per lane.  Its bytes bound it by an order of magnitude.
OPS_SCATTER_LIVE = 200
OPS_RESPAWN = 60
CAM_BYTES = 21 * 4  # one packed camera
# Bytes per lane a hit kernel writes: the record (12 f32, 2 i32, a flag).
RECORD_BYTES = 57
EPS32 = 2.0 ** -24


def _counters() -> dict:
    """Each kernel's launch counter: (module, attribute)."""
    from win32_raytracer_tpu_torch.kernels import bounce as B
    from win32_raytracer_tpu_torch.kernels import draws as DR
    from win32_raytracer_tpu_torch.kernels import hit as K
    from win32_raytracer_tpu_torch.kernels import hit_cols as G
    from win32_raytracer_tpu_torch.kernels import hit_grid as KI
    from win32_raytracer_tpu_torch.kernels import hit_sky as E
    from win32_raytracer_tpu_torch.kernels import scatter as F
    from win32_raytracer_tpu_torch.kernels import tri as KC
    from win32_raytracer_tpu_torch.kernels import tri_cols as H
    from win32_raytracer_tpu_torch.kernels import tri_grid as KD
    return {"hit": (K, "LAUNCHES"), "bounce": (B, "LAUNCHES"),
            "bounce_multi": (B, "MULTI_LAUNCHES"), "hit_sky": (E, "LAUNCHES"),
            "scatter": (F, "LAUNCHES"), "tri": (KC, "LAUNCHES"),
            "tri_grid": (KD, "LAUNCHES"), "tri_grid_sched": (KD, "SCHED_LAUNCHES"),
            "hit_cols": (G, "LAUNCHES"), "tri_cols": (H, "LAUNCHES"),
            "hit_grid": (KI, "LAUNCHES"), "hit_grid_sched": (KI, "SCHED_LAUNCHES"),
            "draws": (DR, "LAUNCHES")}


def reset_launches() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def launches() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def check_route(got: dict, ran: tuple, allowed: tuple, what: str) -> None:
    """Every kernel of ``ran`` launched; none launched outside ``ran`` and
    ``allowed``."""
    check(all(got[k] > 0 for k in ran),
          f"{what}: a kernel of the route was not launched: {got}")
    stray = {k: v for k, v in got.items() if v and k not in ran + allowed}
    check(not stray, f"{what}: kernels off the route launched: {stray}")


def exact_cmp(a, b) -> tuple:
    """Lanes where two tuples of [rows, N] tensors differ in any field,
    and the largest |a - b| over their float fields."""
    n = a[0].shape[-1]
    bad = torch.zeros(n, dtype=torch.bool, device=a[0].device)
    err = 0.0
    for x, y in zip(a, b):
        bad |= (x != y).reshape(-1, n).any(0)
        if x.is_floating_point() and x.numel():
            err = max(err, float((x - y).abs().max()))
    return int(bad.sum()), err


def rows_of(rec) -> tuple:
    """A column record's fields as [rows, N] views (for exact_cmp)."""
    return tuple(x.T if x.dim() == 2 else x[None] for x in rec)


def random_state(dev, n: int, quota: int, seed: int = 11):
    """A random path state: rays from anywhere in the final scene's box,
    a fifth of the lanes dead, pixel ids 0..n-1."""
    from win32_raytracer_tpu_torch.persistent import PathState
    rng = np.random.default_rng(seed)

    def t(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev).contiguous()

    return PathState(
        origin=t(rng.uniform(-12, 12, (3, n))),
        direction=t(rng.normal(0, 1, (3, n))),
        time=t(rng.uniform(0, 0.05, (1, n))),
        throughput=t(rng.uniform(0, 1, (3, n))),
        radiance_sum=t(rng.uniform(0, 1, (3, n))),
        depth=t(np.ones((1, n)), torch.int32),
        sample=t(np.zeros((1, n)), torch.int32),
        pixel=t(np.arange(n)[None], torch.int32),
        path_alive=t(rng.uniform(0, 1, (1, n)) < 0.8, torch.bool),
        s_base=t(np.zeros((1, n)), torch.int32),
        s_quota=t(np.full((1, n), quota), torch.int32),
    )


def card_line(query: str = "name,power.limit") -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed: no host work between the launches, so a small
    launch is timed on the card and not by its Python wrapper (which
    ``cuda_ms`` measures where the wrapper is the slower)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    x = a.astype(np.float64).reshape(-1) - a.mean()
    y = b.astype(np.float64).reshape(-1) - b.mean()
    return float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sphere_ops(table) -> int:
    """f32 operations of one ray's pair tests against every active row of
    a sphere table (SphereTable), tile by tile as sweep_packed stages it."""
    act = table.active.cpu().numpy()
    tv = table.attrs[:, 6:8].cpu().numpy().view(np.uint32)
    ops = 0
    for base in range(0, len(act), 256):
        on = act[base:base + 256]
        rows = tv[base:base + 256][on]
        shared = len(rows) == 0 or bool((rows == rows[0]).all())
        ops += int(on.sum()) * (OPS_SPHERE_PAIR if shared else OPS_SPHERE_PAIR_LERP)
    return ops


def bound(ops: float, nbytes: float, peak_ops: float = PEAK_F32) -> tuple:
    """(bound ms, "operations" or "bytes"); ``peak_ops`` the operations'
    rate (f32 by default)."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fresh_chunk(cfg, dev, salt: int = 12345):
    """The first lane chunk of a render of ``cfg`` on ``dev`` as
    persistent.render_image_persistent sets it up (padded onto the size
    grid), after the step-0 respawn: (state, dims, camera)."""
    from win32_raytracer_tpu_torch.persistent import (
        PathState, _grid_size, _resolve_kpp, make_dims, p_respawn_step)
    from win32_raytracer_tpu_torch.scene.camera import default_camera

    w, h, spp = cfg.width, cfg.height, cfg.samples
    kpp = _resolve_kpp(cfg, spp)
    n_real = w * h * kpp
    n = _grid_size(n_real, 1 << 12)
    i32 = dict(dtype=torch.int32, device=dev)
    direction = torch.zeros((3, n), device=dev)
    direction[2] = 1.0
    sq = torch.full((1, n), spp // kpp, **i32)
    sq[:, n_real:] = 0
    st = PathState(
        origin=torch.zeros((3, n), device=dev), direction=direction,
        time=torch.zeros((1, n), device=dev),
        throughput=torch.ones((3, n), device=dev),
        radiance_sum=torch.zeros((3, n), device=dev),
        depth=torch.zeros((1, n), **i32),
        sample=torch.full((1, n), -1, **i32),
        pixel=torch.arange(n, **i32).clamp_max(n_real - 1)[None],
        path_alive=torch.zeros((1, n), dtype=torch.bool, device=dev),
        s_base=(torch.arange(n, **i32) % kpp * (spp // kpp))[None],
        s_quota=sq)
    cam = default_camera(w, h, device=dev)
    dims = make_dims(cfg, w, h, spp, kpp)
    return p_respawn_step(cam, st, salt, 0, dims, cfg=cfg, lean=True), dims, cam


def variant_tables(table) -> dict:
    """The final scene's table and three variants that the packed sweep
    must get exactly right: "holes", every seventh sphere inactive besides
    the padding; "ties", rows 300-339 copying the geometry of rows 4-43 and
    rows 470-479 that of rows 40-49 (each keeping its own index, so the
    later row must lose every exact tie, also across tiles); "moving", the
    ties with every fifth row's
    shutter interval moved first, so no tile shares one (t1, invdt)."""
    from win32_raytracer_tpu_torch.ops.hit import SphereTable

    out = {"final": table}
    for kind in ("holes", "ties", "moving"):
        attrs, active = table.attrs.clone(), table.active.clone()
        if kind == "holes":
            active[4:488:7] = False
        if kind == "moving":
            attrs[::5, 6] = 0.25                       # t1
            attrs[::5, 7] = 1.0 / (1.0 - attrs[::5, 6])  # invdt
        if kind in ("ties", "moving"):
            for dst, src in ((slice(300, 340), slice(4, 44)),
                             (slice(470, 480), slice(40, 50))):
                attrs[dst, :9] = attrs[src, :9]
        out[kind] = SphereTable(attrs.contiguous(), active.contiguous())
    return out


def bits_cmp(a, b) -> tuple:
    """exact_cmp by bits: lanes where two tuples of [rows, N] tensors
    differ in any bit of any field (NaN equal to NaN of the same bits, -0
    unequal to +0), and the largest |a - b| over their float fields (0
    where the bits agree)."""
    n = a[0].shape[-1]
    bad = torch.zeros(n, dtype=torch.bool, device=a[0].device)
    err = 0.0
    for x, y in zip(a, b):
        if x.is_floating_point():
            diff = (x.contiguous().view(torch.int32) != y.contiguous().view(torch.int32))
            if diff.any():
                err = max(err, float(torch.nan_to_num((x - y).abs()[diff], nan=np.inf).max()))
        else:
            diff = x != y
        bad |= diff.reshape(-1, n).any(0)
    return int(bad.sum()), err


def tri_variant_tables(table, dev) -> dict:
    """The ``mesh`` scene's triangle table (332 triangles padded to 384,
    two stages of 256 candidate rows) and the variants kernels C and H must
    get exactly right (tests/test_torch_tri_sweep_packed.py's): "holes",
    every fifth triangle inactive besides the padding; "ties", rows 260-290
    copying the geometry of rows 10-40 (the next stage) and rows 100-109
    that of rows 50-59 (the same stage), each keeping its own index, so the
    later row loses every exact tie; "nan_pad", the padding rows' geometry
    NaN and inf; "many", two icospheres of 1,280 triangles (six stages),
    every seventh inactive."""
    from win32_raytracer_tpu_torch.ops.hit_tri import TriTable, tri_table
    from win32_raytracer_tpu_torch.scene.triangles import (
        build_triangle_scene, icosphere_mesh)

    out = {"mesh": table}
    for kind in ("holes", "ties", "nan_pad"):
        attrs, active = table.attrs.clone(), table.active.clone()
        if kind == "holes":
            active[0:332:5] = False
        if kind == "ties":
            for dst, src in ((slice(260, 291), slice(10, 41)),
                             (slice(100, 110), slice(50, 60))):
                attrs[dst, :9] = attrs[src, :9]
        if kind == "nan_pad":
            attrs[332::2, :9] = float("nan")
            attrs[333::2, :9] = float("inf")
        out[kind] = TriTable(attrs.contiguous(), active.contiguous())
    parts = [icosphere_mesh((0.0, 1.0, 0.0), 1.0, subdivisions=3),
             icosphere_mesh((2.2, 0.6, 0.4), 0.6, subdivisions=3)]
    offs = np.cumsum([0] + [len(v) for v, _ in parts[:-1]])
    many = tri_table(build_triangle_scene(
        np.concatenate([v for v, _ in parts]),
        np.concatenate([f + k for (_, f), k in zip(parts, offs)]), device=dev))
    active = many.active.clone()
    active[3::7] = False
    out["many"] = TriTable(many.attrs, active.contiguous())
    return out


def tri_rays(table, n: int, seed: int):
    """Rays o/d [n, 3] (card tensors) at a triangle table: a quarter aimed
    at random points of random active triangles (copied rows included), a
    quarter at the midpoints of their edges (shared by two triangles of a
    closed mesh), a quarter at their vertices, and a quarter split between
    rays along a triangle's edge line (det 0) and random directions."""
    rng = np.random.default_rng(seed)
    g = table.attrs[:, :9].cpu().numpy().astype(np.float64)
    act = np.flatnonzero(table.active.cpu().numpy())
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    q = n // 4
    o = rng.uniform([-3.0, 0.0, -2.5], [3.0, 3.5, 4.0], (n, 3))
    d = rng.normal(0, 1, (n, 3))
    pick = rng.choice(act, n)
    a = rng.uniform(0, 1, (n, 2))
    a = np.where(a.sum(1, keepdims=True) > 1, 1 - a, a)
    d[:q] = (v0[pick] + a[:, :1] * e1[pick] + a[:, 1:] * e2[pick])[:q] - o[:q]
    mid = rng.integers(0, 3, n)[:, None]
    em = v0[pick] + np.where(mid == 0, 0.5 * e1[pick], np.where(
        mid == 1, 0.5 * e2[pick], 0.5 * (e1[pick] + e2[pick])))
    d[q:2 * q] = em[q:2 * q] - o[q:2 * q]
    vx = v0[pick] + np.where(mid == 0, 0.0, np.where(mid == 1, e1[pick], e2[pick]))
    d[2 * q:3 * q] = vx[2 * q:3 * q] - o[2 * q:3 * q]
    r = 3 * q + (n - 3 * q) // 2
    o[3 * q:r] = v0[pick[3 * q:r]] - 0.5 * e1[pick[3 * q:r]]
    d[3 * q:r] = e1[pick[3 * q:r]]
    dev = table.attrs.device
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
                 for x in (o, d))


def _ulps(x, k):
    """x (f32) moved k ulps, elementwise (through 0 into the other sign)."""
    x = np.array(x, np.float32)
    k = np.broadcast_to(np.asarray(k), x.shape)
    for step in range(int(np.abs(k).max(initial=0))):
        x = np.where(k > step, np.nextafter(x, np.float32(np.inf)),
                     np.where(-k > step, np.nextafter(x, np.float32(-np.inf)), x))
    return x.astype(np.float32)


def tri_boundary_pairs(min_t: float, seed: int = 0):
    """Triangles and one ray each (numpy f32: g [N, 9], o/d [N, 3]) on the
    exact pair test's boundaries, as tests/test_torch_tri_sweep_packed.py
    builds them: axis-aligned pairs (v0 = 0, e1 = (a, 0, 0), e2 = (0, 1,
    0), the ray from (x, y, h) along -z: det = a, un = x, vn = y a, tn =
    h a) with |det| at 1e-9 +- ulps, anywhere up to 1e38 and with 1 / det
    subnormal, u and v at +-0 and a few ulps, u + v at 1, t at min_t,
    quotients that underflow, infinities, NaNs and products that overflow,
    and (min_t > 0) dets whose subnormal reciprocal lifts t above min_t
    from a tn just below det min_t; then random triangles with rays at
    their edges and vertices from about min_t before the plane."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n = 4000
    mag = np.exp(rng.uniform(np.log(1e-9), np.log(1e38), n)).astype(f32)
    mag[:400] = _ulps(np.full(400, f32(1e-9)), rng.integers(-4, 5, 400))
    mag[400:1000] = np.exp(rng.uniform(np.log(2.0 ** 126), np.log(3.4e38), 600)).astype(f32)
    a = np.where(rng.uniform(size=n) < 0.5, -mag, mag).astype(f32)
    s = np.sign(a).astype(f32)
    k = rng.integers(-3, 4, (n, 3))
    kind = rng.integers(0, 6, n)
    u_t = rng.uniform(0, 1, n).astype(f32)
    v_t = (rng.uniform(0, 1, n) * (1 - u_t)).astype(f32)
    zero = np.zeros(n, f32)
    tiny = f32(2.0) ** rng.integers(-149, -100, n).astype(f32)
    x = np.select([kind == 0, kind == 1, kind == 2],
                  [_ulps(zero, k[:, 0]) * s,
                   _ulps(-(np.abs(a) * f32(2.0 ** -24)).astype(f32), k[:, 0]) * s,
                   -tiny * s], (u_t * a).astype(f32)).astype(f32)
    y = np.select([kind == 4, kind == 5], [_ulps(f32(1) - u_t, k[:, 1]),
                                           _ulps(zero, k[:, 1])], v_t).astype(f32)
    y = np.where(kind == 2, f32(0.25), y).astype(f32)
    h = np.where(rng.uniform(size=n) < 0.5, _ulps(np.full(n, f32(min_t)), k[:, 2]),
                 rng.uniform(min_t, 10, n)).astype(f32)
    for col, vals in ((a, (np.inf, -np.inf, np.nan, 3e38)),
                      (x, (np.inf, -np.inf, np.nan)),
                      (y, (np.inf, np.nan, 3e38)), (h, (np.inf, -np.inf, np.nan, 3e38))):
        sel = rng.choice(n, 80, replace=False)
        col[sel] = rng.choice(np.asarray(vals, f32), 80)
    if min_t > 0:   # 1 / det subnormal, rounded up: t above min_t, tn below
        mt = f32(min_t)
        big = np.exp(rng.uniform(np.log(2.0 ** 126), np.log(3.4e38), 40000)).astype(f32)
        tn = np.nextafter((big * mt).astype(f32), f32(0))
        hb = (tn / big).astype(f32)
        corner = (((hb * big).astype(f32) == tn)
                  & ((tn * (f32(1) / big).astype(f32)).astype(f32) > mt))
        big, hb = big[corner][:300], hb[corner][:300]
        a, h = np.concatenate([a, big]), np.concatenate([h, hb])
        x = np.concatenate([x, (f32(0.25) * big).astype(f32)])
        y = np.concatenate([y, np.full(len(big), f32(0.25))])
    ga = np.zeros((len(a), 9), f32)
    ga[:, 3] = a
    ga[:, 7] = 1.0
    oa = np.stack([x, y, h], 1)
    da = np.tile(np.asarray([0.0, 0.0, -1.0], f32), (len(a), 1))
    m = 2000
    v0 = rng.normal(0, 2, (m, 3))
    e1 = rng.normal(0, 1, (m, 3)) * np.exp(rng.uniform(-12, 12, (m, 1)))
    e2 = rng.normal(0, 1, (m, 3)) * np.exp(rng.uniform(-12, 12, (m, 1)))
    bu = rng.uniform(0, 1, m)
    bv = rng.uniform(0, 1, m) * (1 - bu)
    kb = rng.integers(0, 5, m)
    bu = np.select([kb == 0, kb == 3], [0.0, 0.0], bu)
    bv = np.select([kb == 1, kb == 2, kb == 3], [0.0, 1 - bu, 1.0], bv)
    db = rng.normal(0, 1, (m, 3))
    dist = np.where(rng.uniform(size=m) < 0.5,
                    min_t * (1 + rng.normal(0, 1e-6, m)), rng.uniform(0, 5, m))
    ob = v0 + bu[:, None] * e1 + bv[:, None] * e2 - dist[:, None] * db
    gb = np.concatenate([v0, e1, e2], 1)
    return (np.concatenate([ga, gb]).astype(f32), np.concatenate([oa, ob]).astype(f32),
            np.concatenate([da, db]).astype(f32))


def aim_at_ties(o, d, table, seed: int) -> None:
    """Turn the first quarter of rays o/d [3, N] (card tensors) toward the
    spheres of rows 4-49, the ones the "ties" tables duplicate."""
    rng = np.random.default_rng(seed)
    q = o.shape[1] // 4
    tgt = table.attrs[torch.as_tensor(rng.integers(4, 50, q), device=o.device), :3]
    noise = torch.as_tensor(rng.normal(0, 0.02, (q, 3)), dtype=torch.float32,
                            device=o.device)
    d[:, :q] = (tgt - o[:, :q].T + noise).T


def ptxas_lines(log: str, keys: tuple) -> list:
    """'kernel: N registers, S/L bytes spill stores/loads, M bytes smem'
    for each entry function of nvcc's -Xptxas -v output whose name holds
    one of ``keys``."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)} bytes spill stores/loads"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name and any(k in name for k in keys):
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{demangle(name)}: {m.group(1)} registers, {spill}, "
                       f"{smem.group(1) if smem else 0} bytes smem")
    return out


def demangle(name: str) -> str:
    try:
        out = subprocess.run(["c++filt", name], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    # Drop the parameter list only: template arguments may hold "(".
    return out[:out.rfind("(")] if "(" in out else (out or name)


def sass_text(lib_path: str) -> str:
    """``cuobjdump -sass`` of the built library."""
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    exe = shutil.which("cuobjdump") or os.path.join(cuda, "bin", "cuobjdump")
    return subprocess.run([exe, "-sass", lib_path], capture_output=True,
                          text=True, timeout=600, check=True).stdout


SASS_CLASSES = ("LDS", "LDG", "FADD", "FMUL", "FFMA", "FSETP", "MUFU", "BRA",
                "BSSY", "BSYNC", "BAR")
# The instruction that marks one pair test: a sphere's ``disc >= 0``
# compare; in kernel D a triangle's reciprocal of det (tri_pair_geom's
# division); in kernels C and H the compare |det| >= 1e-9 (f32(1e-9)
# prints as 9.99999971718...e-10), which their mask pass makes once per
# pair with no division.
SPHERE_PAIR_MARK = r"FSETP\.GE\.AND .*, RZ, PT"
TRI_PAIR_MARK = r"MUFU\.RCP"
TRI_MASK_MARK = r"FSETP\.\S+ .*\b9\.99999971\d*e-10\b"


def sass_sweep_mix(dump: str, keys: tuple) -> dict:
    """The issued instructions per pair test in the sweep loops of each
    kernel of a ``cuobjdump -sass`` dump whose name holds one of ``keys``.

    A loop is the code from a branch target up to a branch back to it.  A
    pair test is one ``FSETP.GE ... RZ`` (the ``disc >= 0`` compare), or in
    a triangle kernel (``tri`` in its name) one ``MUFU.RCP``.  A
    loop's hot path is its code outside the loops nested in it and outside
    the root blocks, the code inside it that a forward branch right after
    such a compare jumps over (most pairs miss, so they never run it).  Returns {kernel:
    [{"pairs": p, "per_pair": instructions / p, "LDS": ..., ...}, ...]}
    for each loop with a pair test on its hot path, the counts per pair."""
    out = {}
    for part in re.split(r"\n\s*Function : ", dump)[1:]:
        name, _, body = part.partition("\n")
        name = name.strip()
        if not any(k in name for k in keys):
            continue
        mark = (TRI_MASK_MARK if re.match(r"(void )?tri(_cols)?_kernel\b", demangle(name))
                else TRI_PAIR_MARK if "tri" in name else SPHERE_PAIR_MARK)
        ins = [(int(m.group(1), 16), m.group(3).strip()) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([^;]*);", body)]
        loops, skips = [], []
        for k, (addr, op) in enumerate(ins):
            m = re.match(r"BRA (?:`\()?(0x[0-9a-f]+)", op)
            if not m:
                continue
            tgt = int(m.group(1), 16)
            if tgt <= addr:
                loops.append((tgt, addr))
            elif k and re.match(r"FSETP\.GE\.AND .*, RZ, PT", ins[k - 1][1]):
                skips.append((addr, tgt))
        mixes = []
        for lo, hi in loops:
            inner = [(a, b) for a, b in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]
            hot = [op for a, op in ins if lo <= a <= hi
                   and not any(x <= a <= y for x, y in inner)
                   and not any(lo <= x < a < y <= hi for x, y in skips)]
            pairs = sum(bool(re.match(mark, op)) for op in hot)
            if not pairs:
                continue
            mix = {"pairs": pairs, "per_pair": round(len(hot) / pairs, 2)}
            for c in SASS_CLASSES:
                mix[c] = round(sum(op.split(" ")[0].split(".")[0] == c for op in hot) / pairs, 2)
            mixes.append(mix)
        out[demangle(name)] = mixes
    return out


def sass_opcodes(dump: str, key: str) -> dict:
    """{opcode: count} over the SASS of the first kernel of a ``cuobjdump
    -sass`` dump whose name holds ``key``, most frequent first, with the
    total under "all"."""
    from collections import Counter
    for part in re.split(r"\n\s*Function : ", dump)[1:]:
        name, _, body = part.partition("\n")
        if key in name:
            ops = Counter(m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body))
            return {"all": sum(ops.values()), **dict(ops.most_common())}
    return {}


def sass_digests(dump: str) -> dict:
    """{kernel: first 12 hex digits of the sha1 of its SASS instructions}
    (addresses and encodings dropped) for every kernel of a ``cuobjdump
    -sass`` dump: two builds whose digests agree compiled a kernel to the
    same code."""
    import hashlib
    out = {}
    for part in re.split(r"\n\s*Function : ", dump)[1:]:
        name, _, body = part.partition("\n")
        ins = "\n".join(m.group(1).strip() for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body))
        out[demangle(name.strip())] = hashlib.sha1(ins.encode()).hexdigest()[:12]
    return out


def tri_arrays(tris) -> tuple:
    """(v0, e1, e2) [T, 3] float64 on the host, by triangle index."""
    return tuple(getattr(tris, f).cpu().numpy().astype(np.float64)
                 for f in ("v0", "e1", "e2"))


def mt_f64(o, d, v0, e1, e2):
    """float64 Moller-Trumbore of rays o/d [3, N] against one triangle per
    ray: (u, v, scale S), S = (|e1||e2||o - v0| + |t||e1||e2||d|) / |det|,
    the size of the terms an f32 evaluation of t rounds."""
    o, d = o.T.astype(np.float64), d.T.astype(np.float64)
    p = np.cross(d, e2)
    det = (e1 * p).sum(1)
    tv = o - v0
    q = np.cross(tv, e1)
    t = (e2 * q).sum(1) / det
    nrm = np.linalg.norm
    e12 = nrm(e1, axis=1) * nrm(e2, axis=1)
    s = (e12 * nrm(tv, axis=1) + np.abs(t) * e12 * nrm(d, axis=1)) / np.abs(det)
    return (tv * p).sum(1) / det, (d * q).sum(1) / det, s


def compare_tri(rk, rp, o, d, tris, what, valid=None) -> dict:
    """A triangle kernel's record ``rk`` against ``rp`` (plain, or another
    kernel) on rays o/d [3, N] (card tensors), over the lanes ``valid``
    (all by default).  A winner difference at an exactly equal t is a tie
    (the two sweeps visit triangles in another order); any other hit-mask
    or winner difference must lie within 1e-6 of a triangle edge (|u|,
    |v| or |1-u-v|) and stay at or below 1e-4 of the lanes; t within
    4 f32 epsilons of the formula's scale on agreeing lanes."""
    hk, hp = rk.hit[0].cpu().numpy(), rp.hit[0].cpu().numpy()
    ik, ip = rk.idx[0].cpu().numpy(), rp.idx[0].cpu().numpy()
    tk, tp = rk.t[0].cpu().numpy(), rp.t[0].cpu().numpy()
    if valid is None:
        valid = np.ones(hk.shape, bool)
    diff = valid & ((hk != hp) | (hk & hp & (ik != ip)))
    tie = diff & hk & hp & (tk == tp)
    real = diff & ~tie
    o_np, d_np = o.cpu().numpy(), d.cpu().numpy()
    for idx, hit in ((ik, hk), (ip, hp)):
        sel = real & hit
        if sel.any():
            u, v, _ = mt_f64(o_np[:, sel], d_np[:, sel], *(x[idx[sel]] for x in tris))
            edge = np.minimum(np.minimum(np.abs(u), np.abs(v)), np.abs(1 - u - v))
            check(bool((edge < 1e-6).all()),
                  f"{what}: disagreement off the edge band (edge {edge.max():.3e})")
    check(real.sum() <= 1e-4 * valid.sum(), f"{what}: {real.sum()} disagreements")
    agree = valid & hk & hp & (ik == ip)
    err = 0.0
    for f in ("t", "point", "normal"):
        a = getattr(rk, f).cpu().numpy()[:, agree]
        b = getattr(rp, f).cpu().numpy()[:, agree]
        err = max(err, float(np.abs(a - b).max(initial=0.0)))
    off = agree & (tk != tp)
    if off.any():
        _, _, scale = mt_f64(o_np[:, off], d_np[:, off], *(x[ik[off]] for x in tris))
        check(bool((np.abs(tk[off] - tp[off]) <= 4 * EPS32 * scale).all()),
              f"{what}: t beyond 4 f32 epsilons of its scale")
    return dict(lanes=int(valid.sum()), hits=float(hp[valid].mean()),
                ties=int(tie.sum()), disagree=int(real.sum()), err=err)


def alloc_invariants(pixel, s_base, s_quota, *, n_pix, n_lanes, spp_done,
                     spp, **_):
    """adaptive.alloc_lanes's invariants, exactly, on [L] card tensors:
    L lanes; pixel ids ascending by 0 or 1, from 0 to n_pix - 1 (every pixel
    owns >= 1 lane, a pixel's lanes contiguous); a pixel's first lane
    starts at spp_done, each next lane where the one before ends, its last
    lane ends at spp (its lanes partition its remaining samples)."""
    check(pixel.numel() == n_lanes, f"alloc: {pixel.numel()} lanes, not {n_lanes}")
    step = pixel[1:] - pixel[:-1]
    check(int(pixel[0]) == 0 and int(pixel[-1]) == n_pix - 1
          and bool(((step == 0) | (step == 1)).all()),
          "alloc: pixel ids not every pixel in ascending runs")
    new = torch.ones_like(pixel, dtype=torch.bool)
    new[1:] = step != 0
    end = s_base + s_quota
    last = torch.ones_like(new)
    last[:-1] = new[1:]
    check(bool((s_quota >= 0).all()) and bool((s_base[new] == spp_done).all())
          and bool((s_base[1:][~new[1:]] == end[:-1][~new[1:]]).all())
          and bool((end[last] == spp).all()),
          "alloc: a pixel's lanes do not partition its remaining samples")


def below_cap(rk, rp, cap):
    """Lanes where either record lies below ``cap`` [1, N] (all when cap
    is None): a record beyond a lane's segment end is unspecified."""
    if cap is None:
        return None
    c = cap[0].cpu().numpy()
    return (rk.t[0].cpu().numpy() < c) | (rp.t[0].cpu().numpy() < c)


def fmt_cmp(c: dict) -> str:
    return (f"{c['lanes']} lanes, hits {c['hits']:.3f}, disagreements "
            f"{c['disagree']} (edge band), exact-t ties {c['ties']}, max "
            f"|err| t/point/normal {c['err']:.3e}")


def many_globals_scene(n_big: int, dev, seed: int = 0):
    """A scene whose sphere grid has ``n_big`` globals: the r=1000 ground
    and n_big - 1 spheres of radius 0.7-1.2 over a 60 x 60 floor, among at
    least 600 and twice as many small spheres of radius 0.2 on a jittered
    lattice (the median radius, so every large sphere is above 3x it);
    metal, glass and diffuse spheres (tests/test_torch_grid_sched.py's)."""
    from win32_raytracer_tpu_torch.scene.spheres import SceneBuilder
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for k in range(n_big - 1):
        r = float(rng.uniform(0.7, 1.2))
        c = (float(rng.uniform(-30, 30)), r, float(rng.uniform(-30, 30)))
        if k % 3 == 0:
            b.add_metal(c, r, (0.7, 0.6, 0.5), 0.1)
        elif k % 3 == 1:
            b.add_dielectric(c, r, 1.5)
        else:
            b.add_lambertian(c, r, tuple(rng.uniform(0.1, 0.9, 3)))
    side = int(np.ceil(np.sqrt(max(600, 2 * n_big))))
    step = 60.0 / side
    for a in range(side):
        for c in range(side):
            b.add_lambertian((-30 + step * (a + rng.uniform(0.1, 0.9)), 0.2,
                              -30 + step * (c + rng.uniform(0.1, 0.9))), 0.2,
                             tuple(rng.uniform(0.1, 0.9, 3)))
    return b.build(device=dev)


class Smoke:
    def __init__(self, card: str):
        self.card = card
        self.dev = torch.device("cuda")
        self.kernels = {}
        self.small_mesh_means = {}   # plain small-render means (phase 8)

    def say(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg}", flush=True)

    # ---- phase 1 ----------------------------------------------------------
    def build(self):
        from win32_raytracer_tpu_torch.kernels import _build
        t0 = time.perf_counter()
        path = _build.build()
        _build.load()
        secs = time.perf_counter() - t0
        self.say("1 build", f"{os.path.basename(path)} in {secs:.2f} s "
                 f"(nvcc {_build.build_seconds:.2f} s) from {_build.CSRC}")
        for ln in ptxas_lines(_build.build_log, SWEEP_KERNELS + (DRAW_KERNEL,)):
            self.say("1 ptxas", ln)
        try:
            dump = sass_text(path)
        except (OSError, subprocess.SubprocessError) as e:
            self.say("1 sass", f"cuobjdump unavailable ({e})")
            return
        loops = sass_sweep_mix(dump, SWEEP_KERNELS)
        self.say("1 sass", f"{DRAW_KERNEL}: " + ", ".join(
            f"{k} {v}" for k, v in sass_opcodes(dump, DRAW_KERNEL).items()))
        self.say("1 sass digest", ", ".join(
            f"{k} {v}" for k, v in sorted(sass_digests(dump).items())))
        for name, mixes in loops.items():
            self.say("1 sass", f"{name}: per pair test, each sweep loop's hot "
                     "path: " + "; ".join(", ".join(f"{k} {v}" for k, v in mix.items())
                                          for mix in mixes))

    # ---- phase 2 ----------------------------------------------------------
    def kernel_a(self):
        from win32_raytracer_tpu_torch.kernels import hit as K
        from win32_raytracer_tpu_torch.ops.hit import sphere_table
        from win32_raytracer_tpu_torch.scene.builders import get_scene

        scene = get_scene("final", device=self.dev)
        table = sphere_table(scene)
        n = RANDOM_RAYS
        rng = np.random.default_rng(7)
        o = np.empty((3, n), np.float32)
        # A third from above the ground, a third from the camera region,
        # a third from inside the glass spheres.
        k = n // 3
        o[:, :k] = rng.uniform([-12, 0.01, -12], [12, 4, 12], (k, 3)).T
        o[:, k:2 * k] = (np.array([[15.0], [2.0], [4.0]])
                         + rng.normal(0, 0.3, (3, k)))
        mat_id = scene.mat_id.cpu().numpy()
        glass = np.flatnonzero((mat_id == 2) & scene.active.cpu().numpy())
        pick = rng.choice(glass, n - 2 * k)
        c = scene.center1.cpu().numpy()[pick].T
        r = np.abs(scene.radius.cpu().numpy()[pick])
        off = rng.normal(0, 1, (3, n - 2 * k))
        off *= (0.8 * r * rng.uniform(0, 1, n - 2 * k)) / np.linalg.norm(off, axis=0)
        o[:, 2 * k:] = c + off
        d = rng.normal(0, 1, (3, n)).astype(np.float32)
        tm = rng.uniform(0, 0.05, (1, n)).astype(np.float32)
        o_t, d_t, t_t = (torch.from_numpy(x).to(self.dev) for x in (o, d, tm))

        self.scene, self.table = scene, table
        for kind, tab in variant_tables(table).items():
            d_k = d_t.clone()
            if kind != "final":
                aim_at_ties(o_t, d_k, tab, seed=8)
            rp = K.hit_spheres_rows_plain(tab, o_t, d_k, t_t)
            res = {}
            for label, kw in HIT_FORMS:
                lanes, err = exact_cmp(tuple(K.hit_spheres_rows(tab, o_t, d_k, t_t, **kw)),
                                       tuple(rp))
                res[label] = (lanes, err)
            tied = int(((rp.idx >= 4) & (rp.idx < 50) & rp.hit).sum())
            self.say("2 kernel A", f"{n} rays vs the {kind} table "
                     f"({int(tab.active.sum())} active), hits "
                     f"{float(rp.hit.float().mean()):.3f}, won by a row the "
                     f"ties tables copy {tied}: " + "; ".join(
                         f"{k} {v[0]} lanes differ, max |err| {v[1]:.1e}"
                         for k, v in res.items()))
            for label, (lanes, err) in res.items():
                check(lanes == 0 and err == 0.0,
                      f"kernel A {label} on {kind}: {lanes} lanes, {err}")

    # ---- phase 3 ----------------------------------------------------------
    def kernel_b(self):
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import bounce as B
        from win32_raytracer_tpu_torch.persistent import make_dims
        from win32_raytracer_tpu_torch.scene.camera import default_camera

        # Sizes that are not powers of two, so a reciprocal-multiply in
        # place of a division cannot hide.
        w, h, spp, kpp = 640, 205, 12, 2
        n = RANDOM_RAYS
        dev = self.dev
        st = random_state(dev, n, spp // kpp)
        cam_rows = B.pack_camera(default_camera(w, h, device=dev))
        tables = variant_tables(self.table)
        cases = [("final", True, {}),
                 ("final", False, dict(russian_roulette=True, rr_start_depth=1,
                                       stratify=True)),
                 ("ties", True, {}), ("moving", True, {})]
        for kind, lean, extra in cases:
            cfg = RenderConfig(width=w, height=h, samples=spp,
                               lanes_per_pixel=kpp, **extra)
            dims = make_dims(cfg, w, h, spp, kpp)
            sk = st
            if kind != "final":
                d = st.direction.clone()
                aim_at_ties(st.origin, d, tables[kind], seed=9)
                sk = st._replace(direction=d)
            args = (tables[kind], cam_rows, sk, 0xABC123, 4, dims)
            fp = B.bounce_plain(*args, cfg=cfg, lean=lean)
            lanes, err = exact_cmp(tuple(B.bounce(*args, cfg=cfg, lean=lean)),
                                   tuple(fp))
            # The counting form (stats): the same state, and the live lanes
            # and roulette kills the plain bounce counts from its masks.
            sk_, sp_ = (torch.zeros(2, dtype=torch.int64, device=dev)
                        for _ in range(2))
            cl, ce = exact_cmp(tuple(B.bounce(*args, cfg=cfg, lean=lean,
                                              stats=sk_)), tuple(fp))
            B.bounce_plain(*args, cfg=cfg, lean=lean, stats=sp_)
            self.say("3 kernel B", f"lean={lean}, {kind} table: {n} random "
                     f"lanes at {w}x{h}, kpp {kpp}: {lanes} lanes differ, "
                     f"max |err| {err:.1e}; with stats {cl} lanes differ, "
                     f"[live, kills] {sk_.tolist()} (plain {sp_.tolist()})")
            check(lanes == 0 and err == 0.0,
                  f"kernel B lean={lean} {kind}: {lanes} lanes, {err}")
            check(cl == 0 and ce == 0.0 and torch.equal(sk_, sp_),
                  f"kernel B stats lean={lean} {kind}: {cl} lanes, "
                  f"{sk_.tolist()} vs {sp_.tolist()}")

    # ---- phase 4 ----------------------------------------------------------
    def small_render(self):
        import win32_raytracer_tpu_torch.persistent as P
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig

        base = RenderConfig(width=160, height=120, samples=16, seed=2)
        for label, floor in (("one-shot tail", P._COMPACT_FLOOR),
                             ("compaction, fused bounces", 1 << 14)):
            saved = P._COMPACT_FLOOR
            P._COMPACT_FLOOR = floor
            try:
                rk = render("final", cfg=base, device="cuda")
                rp = render("final", cfg=base.replace(backend="jnp"),
                            device="cuda")
            finally:
                P._COMPACT_FLOOR = saved
            d = float(np.abs(rk.image.astype(float) - rp.image.astype(float)).mean())
            r = pearson(rk.image, rp.image)
            self.say("4 render", f"final 160x120@16 {label}: kernels vs plain "
                     f"mean |diff| {d:.4f} (<=3.0), pearson r {r:.6f} (>=0.98), "
                     f"means {rk.image.mean():.2f}/{rp.image.mean():.2f}, "
                     f"{rk.duration_ms:.0f} ms vs {rp.duration_ms:.0f} ms")
            check(d <= 3.0, f"small render mean diff {d}")
            check(r >= 0.98, f"small render pearson {r}")

    # ---- phase 5 ----------------------------------------------------------
    def headline(self):
        """The headline twice: a warm run under ``multi_backend="xla"``
        that records the batch sizes its torch-chain tail hands kernel A,
        then the counted run on the default route (kernel B, and kernels
        B-multi and B below the floor: no kernel A)."""
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import dispatch as D
        from win32_raytracer_tpu_torch.kernels import hit as K

        cfg = RenderConfig(**HEADLINE)
        sizes = {}
        real = D.hit_spheres_rows

        def spy(scene, origin, *a, **k):
            n = origin.shape[1]
            sizes[n] = sizes.get(n, 0) + 1
            return real(scene, origin, *a, **k)
        D.hit_spheres_rows = spy
        reset_launches()
        try:
            warm = render("final", cfg=cfg.replace(multi_backend="xla"),
                          device="cuda")
        finally:
            D.hit_spheres_rows = real
        got_xla = launches()
        self.tail_sizes = dict(sorted(sizes.items(), reverse=True))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.say("5 headline", f"warm run (multi_backend=\"xla\") "
                 f"{warm.duration_ms / 1e3:.3f} s, mean {warm.image.mean():.3f}, "
                 f"launches {got_xla}; kernel A's batches (rays: "
                 f"launches, rays per thread) " + ", ".join(
                     f"{n}: {c}, {K.rays_per_thread(n, sms)}"
                     for n, c in self.tail_sizes.items()) + f" [{self.card}]")
        reset_launches()
        torch.cuda.synchronize()
        res = render("final", cfg=cfg, device="cuda")
        got = launches()
        mean = float(res.image.mean())
        wall = res.duration_ms / 1e3
        self.say("5 headline", f"final 1200x800@100 spp: {wall:.4f} s, "
                 f"{res.mrays_per_sec:.3f} Mrays/s, image mean {mean:.3f} "
                 f"(170.1 +- 1.5), launches {got} [{self.card}]")
        check(res.image.shape == (800, 1200, 3), f"image shape {res.image.shape}")
        check_route(got, ("bounce", "bounce_multi"), (), "headline")
        check(abs(mean - HEADLINE_MEAN) <= HEADLINE_MEAN_TOL,
              f"headline image mean {mean}")
        for name in ("bounce", "bounce_multi"):
            self.kernels.setdefault(name, {})["launches"] = got[name]
        self.kernels.setdefault("hit", {})["launches"] = got_xla["hit"]

    # ---- kernels at main-path shapes: agreement and times -----------------
    def kernel_main_shapes(self):
        """Holds each kernel exactly against its plain version on inputs the
        headline gives it, then times both.  Kernel B gets the headline
        chunk's first bounce (every lane fresh from the camera) and its
        second (the plain first bounce's output); kernel A gets rays of
        both, in a batch as large as the below-floor tail hands it and in
        tail-sized batches, in each of its launch forms.  Kernel A is timed
        at the tail's batch sizes (phase 5's warm run) and at 524,288,
        65,536 and 8,192 rays, at one and at two rays per thread."""
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import bounce as B
        from win32_raytracer_tpu_torch.kernels import hit as K
        from win32_raytracer_tpu_torch.persistent import (
            _COMPACT_FLOOR, PathState)

        cfg = RenderConfig(**HEADLINE)
        w, h = cfg.width, cfg.height
        st, dims, cam = fresh_chunk(cfg, self.dev)
        n, kpp = st.pixel.shape[1], dims.kpp
        n_real = w * h * kpp
        dev, table = self.dev, self.table
        cam_rows = B.pack_camera(cam)
        m = _COMPACT_FLOOR  # the largest batch the below-floor hit sees

        def spread(state, size):
            """``size`` lanes spread evenly over the image, as a compacted
            tail batch is: their (origin, direction, time)."""
            pick = torch.linspace(0, n_real - 1, size, device=dev).long()
            return tuple(x[:, pick].contiguous()
                         for x in (state.origin, state.direction, state.time))

        errs = {"hit": 0.0, "bounce": 0.0}
        state = st
        for step in (1, 2):
            args = (table, cam_rows, state, 12345, step, dims)
            fp = B.bounce_plain(*args, cfg=cfg, lean=True)
            res = {"B": exact_cmp(tuple(B.bounce(*args, cfg=cfg, lean=True)),
                                  tuple(fp))}
            errs["bounce"] = max(errs["bounce"], res["B"][1])
            for size in (m, 1 << 16, 1 << 12):
                rays = spread(state, size)
                rp = tuple(K.hit_spheres_rows_plain(table, *rays))
                for label, kw in HIT_FORMS:
                    lanes, err = exact_cmp(tuple(K.hit_spheres_rows(table, *rays, **kw)), rp)
                    res[f"A {label} at {size}"] = (lanes, err)
                    errs["hit"] = max(errs["hit"], err)
            self.say("main shapes", f"bounce {step} at {n} lanes ({w}x{h}, "
                     f"kpp {kpp}, lean), kernel A on tail batches of its rays: "
                     + "; ".join(f"{k} {v[0]} lanes differ, max |err| {v[1]:.1e}"
                                 for k, v in res.items()))
            for label, (lanes, err) in res.items():
                check(lanes == 0 and err == 0.0,
                      f"headline bounce {step}: {label}: {lanes} lanes, {err}")
            state = PathState(*(x.contiguous() for x in fp))
        del fp, state

        ray_ops = sphere_ops(table)
        table_bytes = table.attrs.numel() * 4 + table.active.numel()
        # Bounds on these inputs: kernel A sweeps every active sphere for
        # each of its rays (28 bytes in, the record out); kernel B sweeps
        # them for each live lane (73 bytes of state in, 61 out per lane).
        # Kernel B at both bounces, event-timed (cuda_ms: wall per call, the
        # card's time at this size) and from a CUDA graph (graph_ms: the
        # card's time alone).
        st2 = B.bounce(table, cam_rows, st, 12345, 1, dims, cfg=cfg, lean=True)
        b_ms = {}
        for step, state in ((1, st), (2, st2)):
            fn = (lambda state=state, step=step: B.bounce(
                table, cam_rows, state, 12345, step, dims, cfg=cfg, lean=True))
            b_ms[step] = (cuda_ms(fn, 10), graph_ms(fn, 5))
        b_plain = cuda_ms(lambda: B.bounce_plain(table, cam_rows, st, 12345, 1,
                                                 dims, cfg=cfg, lean=True), 2)
        live = int(st.path_alive.sum())
        b_bound = bound(live * ray_ops, n * (73 + 61) + table_bytes + CAM_BYTES)
        self.kernels.setdefault("bounce", {}).update(
            ms=b_ms[1][0], plain_ms=b_plain,
            max_abs_err=errs["bounce"], bound_ms=b_bound[0], bound_by=b_bound[1])
        for step, state in ((1, st), (2, st2)):
            lv = int(state.path_alive.sum())
            lb = bound(lv * ray_ops, n * (73 + 61) + table_bytes + CAM_BYTES)[0]
            floor = lv * ray_ops / PEAK_F32_UNFUSED * 1e3
            self.say("times", f"kernel B, bounce {step}, {n} lanes ({lv} live): "
                     f"{b_ms[step][0]:.4f} ms (graph {b_ms[step][1]:.4f})"
                     + (f", plain {b_plain:.3f} ms" if step == 1 else "")
                     + f", bound {lb:.4f} ms, --fmad=false floor {floor:.4f} ms "
                     f"[{self.card}]")
        del st2

        # Kernel A at the tail's batch sizes (phase 5's warm run) and at
        # 524,288, 65,536 and 8,192 rays, at one and two rays per thread.  A
        # small batch's wall per call is its Python wrapper's; graph_ms gives
        # the card's time.  The kernels line takes the event-timed ms at
        # 524,288 rays, as it does for every kernel.
        tail = getattr(self, "tail_sizes", {})
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for size in sorted(set(tail) | {m, 1 << 16, 1 << 13}, reverse=True):
            rays = spread(st, size)
            t = {}
            for r in (1, 2):
                fn = lambda r=r: K.hit_spheres_rows(table, *rays, _rays=r)
                t[f"{r} ray(s)/thread"] = (cuda_ms(fn, max(10, (1 << 21) // size)),
                                           graph_ms(fn, 20))
            bnd = bound(size * ray_ops, size * (28 + RECORD_BYTES) + table_bytes)
            floor = size * ray_ops / PEAK_F32_UNFUSED * 1e3
            if size == m:
                ms = cuda_ms(lambda: K.hit_spheres_rows(table, *rays), 20)
                plain = cuda_ms(lambda: K.hit_spheres_rows_plain(table, *rays), 3)
                self.kernels.setdefault("hit", {}).update(
                    ms=ms, plain_ms=plain, max_abs_err=errs["hit"],
                    bound_ms=bnd[0], bound_by=bnd[1])
            self.say("times", f"kernel A at {size} rays ({tail.get(size, 0)} "
                     "headline launches; default "
                     f"{K.rays_per_thread(size, sms)} ray(s)/thread): "
                     + ", ".join(f"{k} {v[0]:.4f} ms (graph {v[1]:.4f})"
                                 for k, v in t.items())
                     + f"; bound {bnd[0]:.4f} ms ({bnd[1]}), --fmad=false "
                     f"floor {floor:.4f} ms [{self.card}]")

    # ---- phase 17 ---------------------------------------------------------
    def ab_times(self):
        """Kernels A, B, E and G alone at their main paths' shapes, and the
        grid wrappers at theirs, through the public wrappers with their
        default launch forms only, so that the same code times an earlier
        checkout of the package (--root): kernels B and E on the headline
        chunk's first bounce, kernel A on 524,288, 262,144, 65,536, 32,768
        and 8,192 of its rays, each event-timed and from a CUDA graph
        (B and A); kernel G and its v1 adapter (wavefront_times); kernels D
        and I (grid_times); kernels C and H (tri_times).  One JSON line."""
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import bounce as B
        from win32_raytracer_tpu_torch.kernels import hit as K
        from win32_raytracer_tpu_torch.kernels import hit_sky as E
        from win32_raytracer_tpu_torch.ops.hit import sphere_table
        from win32_raytracer_tpu_torch.scene.builders import get_scene

        cfg = RenderConfig(**HEADLINE)
        table = sphere_table(get_scene("final", device=self.dev))
        st, dims, cam = fresh_chunk(cfg, self.dev)
        cam_rows = B.pack_camera(cam)
        n_real = cfg.width * cfg.height * dims.kpp

        def bounce():
            return B.bounce(table, cam_rows, st, 12345, 1, dims, cfg=cfg, lean=True)
        out = {"bounce_ms": cuda_ms(bounce, 20), "bounce_graph_ms": graph_ms(bounce, 10),
               "hit_sky_ms": cuda_ms(lambda: E.hit_sky(table, st, cfg=cfg), 20)}
        for size in (1 << 19, 1 << 18, 1 << 16, 1 << 15, 1 << 13):
            pick = torch.linspace(0, n_real - 1, size, device=self.dev).long()
            o, d, t = (x[:, pick].contiguous() for x in (st.origin, st.direction, st.time))

            def hit():
                return K.hit_spheres_rows(table, o, d, t)
            out[f"hit_ms_{size}"] = cuda_ms(hit, max(20, (1 << 22) // size))
            out[f"hit_graph_ms_{size}"] = graph_ms(hit, 20)
        del st
        out.update(self.wavefront_times(table))
        out.update(self.grid_times())
        out.update(self.tri_times())
        import win32_raytracer_tpu_torch as pkg
        print(json.dumps({"ab_times": out, "package": os.path.dirname(pkg.__file__),
                          "card": self.card}), flush=True)

    def wavefront_times(self, table) -> dict:
        """Kernel G (hit_spheres_cols, and the v1 adapter onto it) at the
        wavefront's shape, ``final`` 1200x800@4's first-bounce rays
        (3,840,000), and the adapter at 262,144 of them (phase 17)."""
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.core.rng import fold_in, prng_key
        from win32_raytracer_tpu_torch.kernels import hit_cols as G
        from win32_raytracer_tpu_torch.kernels.experimental.hit_pallas_v1 import (
            hit_spheres_pallas)
        from win32_raytracer_tpu_torch.render import make_primary_rays
        from win32_raytracer_tpu_torch.scene.camera import default_camera

        cfg = RenderConfig(**WAVEFRONT)
        w, h, spp = cfg.width, cfg.height, cfg.samples
        st = make_primary_rays(default_camera(w, h, device=self.dev), 0,
                               fold_in(fold_in(prng_key(0), 0), 1), cfg=cfg,
                               width=w, height=h, spp=spp, rows=h)
        o, d, t = st.origin, st.direction, st.time
        pick = torch.linspace(0, o.shape[0] - 1, 1 << 18, device=self.dev).long()
        o_s, d_s, t_s = (x[pick].contiguous() for x in (o, d, t))
        return {"hit_cols_ms": cuda_ms(lambda: G.hit_spheres_cols(table, o, d, t), 20),
                "hit_v1_ms_262144": cuda_ms(
                    lambda: hit_spheres_pallas(table, o_s, d_s, t_s), 20)}

    def tri_times(self) -> dict:
        """Kernels C and H at their main paths' shapes, event-timed through
        the public wrappers (phase 17): C on 524,288 of the ``mesh``
        render's bounce-1 rays (800x450, 50 spp, picked as phase 6 picks
        them), H on the wavefront ``mesh`` 800x450@4's first-bounce rays
        (1,440,000)."""
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.core.rng import fold_in, prng_key
        from win32_raytracer_tpu_torch.kernels import tri as KC
        from win32_raytracer_tpu_torch.kernels import tri_cols as H
        from win32_raytracer_tpu_torch.kernels.dispatch import (
            get_hit_fn_rows_accel, hit_tables)
        from win32_raytracer_tpu_torch.render import make_primary_rays
        from win32_raytracer_tpu_torch.scene.builders import get_scene
        from win32_raytracer_tpu_torch.scene.camera import default_camera

        dev = self.dev
        scene = get_scene("mesh", device=dev)
        tab = get_hit_fn_rows_accel(RenderConfig(), scene)[0].triangles
        st, _, _ = fresh_chunk(RenderConfig(**CONFIG4), dev)
        pick = torch.linspace(0, st.pixel.shape[1] - 1, 1 << 19, device=dev).long()
        o, d = (x[:, pick].contiguous() for x in (st.origin, st.direction))
        tm = torch.zeros((1, 1 << 19), device=dev)
        del st
        out = {"tri_ms": cuda_ms(lambda: KC.hit_triangles_rows(tab, o, d, tm), 20)}
        cfg = RenderConfig(**WAVEFRONT_MESH)
        w, h, spp = cfg.width, cfg.height, cfg.samples
        st = make_primary_rays(default_camera(w, h, device=dev), 0,
                               fold_in(fold_in(prng_key(0), 0), 1), cfg=cfg,
                               width=w, height=h, spp=spp, rows=h)
        cols = hit_tables(scene).triangles
        out["tri_cols_ms"] = cuda_ms(
            lambda: H.hit_triangles_cols(cols, st.origin, st.direction, st.time), 10)
        return out

    def grid_times(self) -> dict:
        """The grid wrappers at their main-path shapes, event-timed through
        the public entry points only (phase 17): kernel D
        (hit_triangles_grid_rows) on config 4's binned second bounce, capped
        by the sphere pass, and kernel I (hit_spheres_grid_rows, and its
        column instance through the experimental hit_spheres_grid_pallas)
        on the grid headline's second bounce; each chunk's first bounce is
        taken by the package's own hit functions."""
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import hit as K
        from win32_raytracer_tpu_torch.kernels import hit_grid as KI
        from win32_raytracer_tpu_torch.kernels import tri_grid as KD
        from win32_raytracer_tpu_torch.kernels.dispatch import get_hit_fn_rows_accel
        from win32_raytracer_tpu_torch.kernels.experimental.hit_grid import (
            hit_spheres_grid_pallas)
        from win32_raytracer_tpu_torch.persistent import (
            _bin_sort_core, _derive_bin_box, p_bounce_step)
        from win32_raytracer_tpu_torch.scene.builders import get_scene

        dev, out = self.dev, {}
        cfg = RenderConfig(**CONFIG4)
        hit_scene, fn = get_hit_fn_rows_accel(cfg, get_scene("mesh20k", device=dev))
        box = _derive_bin_box(cfg, hit_scene)
        st, dims, cam = fresh_chunk(cfg, dev)
        st = _bin_sort_core(st, box=box)
        st = p_bounce_step(hit_scene, cam, st, 12345, 1, dims, cfg=cfg, hit_fn=fn,
                           lean=True)
        st = _bin_sort_core(st, box=box)
        o, d, t = (x.contiguous() for x in (st.origin, st.direction, st.time))
        cap = K.hit_spheres_rows(hit_scene.spheres, o, d, t).t.contiguous()
        zeros = torch.zeros_like(t)
        grid = hit_scene.triangles
        out["tri_grid_ms"] = cuda_ms(
            lambda: KD.hit_triangles_grid_rows(grid, o, d, zeros, t_cap=cap), 20)
        del st, o, d, t, cap, zeros

        cfg = RenderConfig(**HEADLINE, accel="grid")
        gscene, fn = get_hit_fn_rows_accel(cfg, get_scene("final", device=dev))
        st, dims, cam = fresh_chunk(cfg, dev)
        st = p_bounce_step(gscene, cam, st, 12345, 1, dims, cfg=cfg, hit_fn=fn,
                           lean=True)
        o, d, t = (x.contiguous() for x in (st.origin, st.direction, st.time))
        del st
        out["hit_grid_ms"] = cuda_ms(lambda: KI.hit_spheres_grid_rows(gscene, o, d, t), 20)
        oc, dc, tc = o.T.contiguous(), d.T.contiguous(), t[0].contiguous()
        out["hit_grid_cols_ms"] = cuda_ms(
            lambda: hit_spheres_grid_pallas(gscene, oc, dc, tc), 20)
        for key, args in (("hit_grid_sched_ms", (o, d, t, False)),
                          ("hit_grid_cols_sched_ms", (oc, dc, tc, True))):
            p = KI.prepare(gscene, *args[:3], cfg.min_hit_t, 2048, args[3])
            out[key] = cuda_ms(lambda: KI.schedule(p), 20)
        return out

    # ---- phase 6 ----------------------------------------------------------
    def tri_boundary_groups(self, min_t: float, cols: bool):
        """tri_boundary_pairs as tables of 32 triangles (one mask chunk) on
        the card, each with its 32 rays: [(table, o, d)], the rays [3, n]
        (rows) or [n, 3] (cols)."""
        from win32_raytracer_tpu_torch.ops.hit_tri import TRI_ATTR_COLS, TriTable
        g, o, d = tri_boundary_pairs(min_t)
        out = []
        for i0 in range(0, len(g) - 31, 32):
            attrs = np.zeros((32, TRI_ATTR_COLS), np.float32)
            attrs[:, :9] = g[i0:i0 + 32]
            attrs[:, 15] = np.arange(32)
            tab = TriTable(torch.as_tensor(attrs, device=self.dev),
                           torch.ones(32, dtype=torch.bool, device=self.dev))
            oo, dd = (torch.as_tensor(x[i0:i0 + 32], device=self.dev) for x in (o, d))
            if not cols:
                oo, dd = oo.T, dd.T
            out.append((tab, oo.contiguous(), dd.contiguous()))
        return out

    def kernel_c(self):
        """Kernel C held exactly against its plain version (every field's
        bits, 0 lanes differ, max |err| 0) in each launch form (default,
        one and two rays a thread): 262,144 rays at the mesh scene's table
        and its variants (tri_variant_tables: inactive rows, copied rows,
        NaN padding, six stages) aimed at points, edges and vertices and
        along edges (tri_rays); the boundary pairs (tri_boundary_pairs, 32
        to a table); then 524,288 rays of the first and second bounce of a
        mesh render's chunk (800x450, 50 spp, kpp 2), each form timed on
        the first."""
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import tri as KC
        from win32_raytracer_tpu_torch.kernels.dispatch import (
            get_hit_fn_rows_accel)
        from win32_raytracer_tpu_torch.persistent import p_bounce_step
        from win32_raytracer_tpu_torch.scene.builders import get_scene

        dev = self.dev
        scene = get_scene("mesh", device=dev)
        tab = get_hit_fn_rows_accel(RenderConfig(), scene)[0].triangles
        err = 0.0

        def hold(t, o, d, what, min_t=RenderConfig().min_hit_t):
            tm = torch.zeros((1, o.shape[1]), device=dev)
            rp = tuple(KC.hit_triangles_rows_plain(t, o, d, tm, min_t=min_t))
            res = {label: bits_cmp(tuple(KC.hit_triangles_rows(t, o, d, tm, min_t, **kw)), rp)
                   for label, kw in HIT_FORMS}
            for label, (lanes, e) in res.items():
                check(lanes == 0 and e == 0.0,
                      f"kernel C {label} {what}: {lanes} lanes differ, max |err| {e}")
            return res, float(rp[0].float().mean())

        for kind, t in tri_variant_tables(tab, dev).items():
            o, d = tri_rays(t, RANDOM_RAYS, seed=17 + len(kind))
            res, hits = hold(t, o.T.contiguous(), d.T.contiguous(), f"on {kind}")
            err = max(err, *(v[1] for v in res.values()))
            self.say("6 kernel C", f"{RANDOM_RAYS} rays vs the {kind} table "
                     f"({int(t.active.sum())} active of {t.attrs.shape[0]}), hits "
                     f"{hits:.3f}: " + "; ".join(f"{k} {v[0]} lanes differ, max "
                                               f"|err| {v[1]:.1e}" for k, v in res.items()))
        for min_t in (RenderConfig().min_hit_t, 0.0):
            groups = self.tri_boundary_groups(min_t, cols=False)
            lanes = 0
            for t, o, d in groups:
                res, _ = hold(t, o, d, f"boundary pairs, min_t {min_t}", min_t)
                err = max(err, *(v[1] for v in res.values()))
                lanes += o.shape[1]
            self.say("6 kernel C", f"boundary pairs, min_t {min_t}: {len(groups)} "
                     f"tables of 32, {lanes} rays, every form 0 lanes differ")

        cfg = RenderConfig(**CONFIG4, backend="jnp")
        st, dims, cam = fresh_chunk(cfg, dev)
        hit_scene, plain_fn = get_hit_fn_rows_accel(cfg, scene)
        m = 1 << 19
        pick = torch.linspace(0, st.pixel.shape[1] - 1, m, device=dev).long()
        for bounce in (1, 2):
            o_t, d_t = (x[:, pick].contiguous() for x in (st.origin, st.direction))
            tm = torch.zeros((1, m), device=dev)
            res, hits = hold(tab, o_t, d_t, f"mesh render bounce {bounce}")
            err = max(err, *(v[1] for v in res.values()))
            self.say("6 kernel C", f"mesh render bounce {bounce}, {m} of its "
                     f"rays, hits {hits:.3f}: " + "; ".join(
                         f"{k} {v[0]} lanes differ, max |err| {v[1]:.1e}"
                         for k, v in res.items()))
            if bounce == 1:
                times = (cuda_ms(lambda: KC.hit_triangles_rows(tab, o_t, d_t, tm), 10),
                         cuda_ms(lambda: KC.hit_triangles_rows_plain(tab, o_t, d_t, tm), 2))
                forms = {k: cuda_ms(lambda: KC.hit_triangles_rows(tab, o_t, d_t, tm, **kw), 10)
                         for k, kw in HIT_FORMS[1:]}
                st = p_bounce_step(hit_scene, cam, st, 12345, 1, dims, cfg=cfg,
                                   hit_fn=plain_fn, lean=True)
        active = int(tab.active.sum())
        b = bound(m * active * OPS_TRI_PAIR,
                  m * (24 + RECORD_BYTES) + tab.attrs.numel() * 4 + tab.active.numel())
        self.kernels.setdefault("tri", {}).update(
            ms=times[0], plain_ms=times[1], max_abs_err=err, bound_ms=b[0],
            bound_by=b[1])
        floor = m * active * OPS_TRI_PAIR / PEAK_F32_UNFUSED * 1e3
        self.say("6 kernel C", f"at {m} rays x {active} triangles: kernel "
                 f"{times[0]:.4f} ms (" + ", ".join(f"{k} {v:.4f}" for k, v in forms.items())
                 + f"), plain {times[1]:.3f} ms, bound {b[0]:.4f} ms ({b[1]}), "
                 f"--fmad=false floor {floor:.4f} ms [{self.card}]")

    # ---- phase 7 ----------------------------------------------------------
    def kernel_d(self):
        """Kernel D against the plain grid sweep and against kernel C, at
        config 4's chunk (mesh20k, 800x450, 50 spp: 720,896 lanes): the
        binned first bounce without t_cap; the binned second bounce with
        the sphere pass's t_cap; the second again with the early exit and
        the any-touch skip off; median tiles of 200 rows and ray blocks of
        1,000 lanes, with the knobs on and off; then a grid of 61,440 tiles
        (kernel_d_many_tiles).  Every comparison must be exact (no disagreement, no
        differing tie, max |err| 0), and the schedule kernel's sched,
        bounds and segment ends integer-equal to the torch prelude's.
        Times: both launches, each alone, and the prelude; bounds from the
        pair and any-touch tests the sweep's stats count."""
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import hit as K
        from win32_raytracer_tpu_torch.kernels import tri as KC
        from win32_raytracer_tpu_torch.kernels import tri_grid as KD
        from win32_raytracer_tpu_torch.kernels.dispatch import (
            get_hit_fn_rows_accel)
        from win32_raytracer_tpu_torch.persistent import (
            _bin_sort_core, _derive_bin_box, p_bounce_step)
        from win32_raytracer_tpu_torch.scene.builders import get_scene
        from win32_raytracer_tpu_torch.tri_accel import (
            DEFAULT_TRI_GRID_RAY_BLOCK, build_tri_grid,
            hit_triangles_grid_rows_plain)

        dev = self.dev
        cfg = RenderConfig(**CONFIG4, backend="jnp")
        hit_scene, plain_fn = get_hit_fn_rows_accel(cfg, get_scene("mesh20k", device=dev))
        grid, spheres = hit_scene.triangles, hit_scene.spheres
        tris = tri_arrays(grid.base)
        box = _derive_bin_box(cfg, hit_scene)
        st, dims, cam = fresh_chunk(cfg, dev)
        n = st.pixel.shape[1]
        st = _bin_sort_core(st, box=box)
        o1, d1 = st.origin.contiguous(), st.direction.contiguous()
        st = p_bounce_step(hit_scene, cam, st, 12345, 1, dims, cfg=cfg,
                           hit_fn=plain_fn, lean=True)
        st = _bin_sort_core(st, box=box)
        o2, d2, t2 = (x.contiguous() for x in (st.origin, st.direction, st.time))
        cap2 = K.hit_spheres_rows(spheres, o2, d2, t2).t.contiguous()
        del st
        zeros = torch.zeros((1, n), device=dev)
        rb = DEFAULT_TRI_GRID_RAY_BLOCK
        err, times, work = 0.0, {}, {}
        arms = (("bounce 1", o1, d1, None, True),
                ("bounce 2, t_cap", o2, d2, cap2, True),
                ("bounce 2, t_cap, early exit and any-touch off", o2, d2, cap2, False))
        for label, o, d, cap, knobs in arms:
            kw = dict(t_cap=cap, early_exit=knobs, any_skip=knobs)
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            rk = KD.hit_triangles_grid_rows(grid, o, d, zeros, stats=stats, **kw)
            rp = hit_triangles_grid_rows_plain(grid, o, d, zeros, **kw)
            torch.cuda.synchronize()
            c = compare_tri(rk, rp, o, d, tris, f"kernel D {label}",
                            below_cap(rk, rp, cap))
            check(c["disagree"] == 0 and c["ties"] == 0 and c["err"] == 0.0,
                  f"kernel D {label}: not exact against plain ({fmt_cmp(c)})")
            err = max(err, c["err"])
            self.schedule_d(grid, o, d, cap, cfg.min_hit_t, rb, label)
            tiles, pairs, touches, walked = (int(x) for x in stats.cpu())
            ctas = -(-n // rb) * -(-rb // KD.SWEEP_LANES_PER_CTA)
            self.say("7 kernel D", f"{label} vs plain: {fmt_cmp(c)}; swept "
                     f"{tiles} CTA tiles, {pairs} pair tests "
                     f"({pairs / n:.0f} per lane), {touches} any-touch tests; "
                     f"per CTA ({ctas}): {walked / ctas:.1f} schedule entries "
                     f"walked, {tiles / ctas:.1f} tiles staged")
            if cap is None:
                cb = compare_tri(rk, KC.hit_triangles_rows(grid.base, o, d, zeros),
                                 o, d, tris, f"kernel D {label} vs kernel C")
                self.say("7 kernel D", f"{label} vs kernel C (brute, "
                         f"{grid.base.padded_size} triangles): {fmt_cmp(cb)}")
                times["brute"] = cuda_ms(
                    lambda: KC.hit_triangles_rows(grid.base, o, d, zeros), 3)
            times[label] = (
                cuda_ms(lambda: KD.hit_triangles_grid_rows(grid, o, d, zeros, **kw), 5),
                cuda_ms(lambda: hit_triangles_grid_rows_plain(grid, o, d, zeros, **kw), 1))
            work[label] = (pairs, touches)
        fn_bytes = (n * (24 + 4 + RECORD_BYTES) + grid.tile_attrs.numel() * 4
                    + grid.tile_boxes.numel() * 4)
        sched_bytes = (n * (24 + 4 + 4) + grid.tile_boxes.numel() * 4
                       + 2 * (-(-n // rb)) * (grid.n_tiles + 1) * 4)
        sched_ops = n * OPS_TRI_CLIP + (-(-n // rb)) * grid.n_tiles * OPS_TRI_TLO
        sb = bound(sched_ops, sched_bytes)
        for label, o, d, cap, knobs in arms:
            pairs, touches = work[label]
            # The wrapper's bound: both launches' operations, the function's
            # bytes (rays in, record out, the grid's tables).
            bl = bound(pairs * OPS_TRI_PAIR + touches * OPS_ANY_TOUCH + sched_ops,
                       fn_bytes)
            # Each launch alone: the schedule kernel, then the sweep on its
            # output; the schedule's plain version (the torch prelude).
            p = KD.prepare(grid, o, d, cap, cfg.min_hit_t, rb)
            sched_ms = cuda_ms(lambda: KD.schedule(p), 10)
            sweep_ms = cuda_ms(lambda: KD.launch(p, knobs, knobs), 10)
            pre = cuda_ms(lambda: KD.schedule_plain(grid, o, d, cap, cfg.min_hit_t, rb), 5)
            self.say("7 times", f"{label} at {n} lanes: kernel D "
                     f"{times[label][0]:.3f} ms (schedule kernel {sched_ms:.4f} ms, "
                     f"its torch prelude {pre:.3f} ms, bound {sb[0]:.4f} ms ({sb[1]}); "
                     f"sweep alone {sweep_ms:.3f} ms), plain "
                     f"{times[label][1]:.3f} ms, bound {bl[0]:.4f} ms "
                     f"({bl[1]}) [{self.card}]")
            if label == arms[1][0]:
                # The kernels line reports the main path's case: the second
                # bounce, capped by the sphere pass, knobs at their defaults.
                self.kernels.setdefault("tri_grid", {}).update(
                    ms=times[label][0], plain_ms=times[label][1], max_abs_err=err,
                    bound_ms=bl[0], bound_by=bl[1])
                self.kernels.setdefault("tri_grid_sched", {}).update(
                    ms=sched_ms, plain_ms=pre, max_abs_err=0.0, bound_ms=sb[0],
                    bound_by=sb[1])
        self.say("7 times", f"kernel C on bounce 1's rays ({grid.base.padded_size} "
                 f"triangles): {times['brute']:.3f} ms [{self.card}]")

        # Knobs off their defaults on bounce 2 with t_cap: median-split
        # tiles of 200 rows (50 rows for each of a lane's four threads) and
        # ray blocks of 1,000 lanes (a CTA of 8 lanes closing each block,
        # filler rays in the last); the early exit and any-touch skip on,
        # then off.
        odd = build_tri_grid(grid.base, tile_rows=200, partition="median")
        for knobs in (True, False):
            label = (f"bounce 2, t_cap, median tiles of {odd.tile_rows} rows, "
                     f"ray blocks of 1000, early exit and any-touch "
                     f"{'on' if knobs else 'off'}")
            kw = dict(t_cap=cap2, ray_block=1000, early_exit=knobs, any_skip=knobs)
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            rk = KD.hit_triangles_grid_rows(odd, o2, d2, zeros, stats=stats, **kw)
            rp = hit_triangles_grid_rows_plain(odd, o2, d2, zeros, **kw)
            torch.cuda.synchronize()
            c = compare_tri(rk, rp, o2, d2, tris, f"kernel D {label}",
                            below_cap(rk, rp, cap2))
            tiles, pairs, touches, _ = (int(x) for x in stats.cpu())
            self.say("7 kernel D", f"{label} vs plain: {fmt_cmp(c)}; swept "
                     f"{tiles} CTA tiles of {odd.n_tiles}, {pairs} pair tests, "
                     f"{touches} any-touch tests")
            check(c["disagree"] == 0 and c["ties"] == 0 and c["err"] == 0.0,
                  f"kernel D {label}: not exact against plain ({fmt_cmp(c)})")
            check(pairs > 0, f"kernel D {label}: no pair test")
        self.schedule_d(odd, o2, d2, cap2, cfg.min_hit_t, 1000,
                        f"bounce 2, t_cap, median tiles of {odd.tile_rows} "
                        "rows, ray blocks of 1000")
        del o1, d1, o2, d2, t2, cap2, zeros
        self.kernel_d_many_tiles()

    def kernel_d_many_tiles(self):
        """Kernel D on a grid of more tiles than a CTA can rank in shared
        memory: three icospheres (491,520 triangles) in Morton tiles of 8
        rows, 61,440 tiles; 65,536 rays (MANY_TILE_RAYS) in blocks of 2,048, half camera
        rays at the meshes, half bounce-like rays leaving their surfaces in
        every direction (blocks that schedule most tiles, which the
        schedule kernel orders by its radix sort).  The schedule kernel
        integer-equal to the torch prelude, the sweep exact against the
        plain sweep (0 lanes, 0 ties, max |err| 0), the schedule kernel
        timed."""
        from win32_raytracer_tpu_torch.kernels import tri_grid as KD
        from win32_raytracer_tpu_torch.scene.triangles import (
            build_triangle_scene, icosphere_mesh)
        from win32_raytracer_tpu_torch.tri_accel import (
            build_tri_grid, hit_triangles_grid_rows_plain)

        dev = self.dev
        parts = [icosphere_mesh((0.0, 1.5, 0.0), 1.5, subdivisions=7),
                 icosphere_mesh((3.2, 0.8, 0.5), 0.8, subdivisions=6),
                 icosphere_mesh((-3.0, 0.8, -0.5), 0.8, subdivisions=6)]
        offs = np.cumsum([0] + [len(v) for v, _ in parts[:-1]])
        scene = build_triangle_scene(np.concatenate([v for v, _ in parts]),
                                     np.concatenate([f + k for (_, f), k in zip(parts, offs)]),
                                     device=dev)
        grid = build_tri_grid(scene, tile_rows=8)
        tris = tri_arrays(scene)
        check(grid.n_tiles > 60000, f"many-tile grid: {grid.n_tiles} tiles")
        rng = np.random.default_rng(71)
        n, rb = MANY_TILE_RAYS, 2048
        h = n // 2
        o = np.empty((3, n), np.float32)
        d = np.empty((3, n), np.float32)
        o[:, :h] = (np.array([[9.0], [3.0], [7.0]])
                    + rng.normal(0, 0.05, (3, h)))
        d[:, :h] = (rng.uniform([-4.0, 0.0, -1.5], [4.0, 3.0, 1.5], (h, 3)).T
                    - o[:, :h])
        # Bounce-like: points on the big sphere's surface, pushed out a
        # little, in blocks of 2,048 around a few spots, any direction.
        spots = rng.normal(0, 1, (n // rb // 2, 3))
        spots /= np.linalg.norm(spots, axis=1, keepdims=True)
        pts = np.repeat(spots, rb, axis=0) + rng.normal(0, 0.3, (n - h, 3))
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        o[:, h:] = (np.array([0.0, 1.5, 0.0]) + 1.502 * pts).T
        d[:, h:] = rng.normal(0, 1, (3, n - h))
        o_t, d_t = (torch.as_tensor(x, device=dev).contiguous() for x in (o, d))
        zeros = torch.zeros((1, n), device=dev)
        min_t = 1e-3
        stats = torch.zeros(4, dtype=torch.int64, device=dev)
        rk = KD.hit_triangles_grid_rows(grid, o_t, d_t, zeros, stats=stats)
        t0 = time.perf_counter()
        rp = hit_triangles_grid_rows_plain(grid, o_t, d_t, zeros)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        c = compare_tri(rk, rp, o_t, d_t, tris, "kernel D, many tiles")
        tiles, pairs, touches, walked = (int(x) for x in stats.cpu())
        p = KD.prepare(grid, o_t, d_t, None, min_t, rb)
        sched_ms = cuda_ms(lambda: KD.schedule(p), 10)
        pre_ms = cuda_ms(lambda: KD.schedule_plain(grid, o_t, d_t, None, min_t, rb), 3)
        full_ms = cuda_ms(lambda: KD.hit_triangles_grid_rows(grid, o_t, d_t, zeros), 5)
        sched = KD.schedule_plain(grid, o_t, d_t, None, min_t, rb)[0]
        counts = sched[:, 0]
        self.say("7 many tiles", f"{scene.padded_size} triangles in {grid.n_tiles} "
                 f"tiles of {grid.tile_rows} rows, {n} rays in {counts.numel()} "
                 f"blocks of {rb} (scheduled tiles per block: min {int(counts.min())}, "
                 f"max {int(counts.max())}, {int((counts > 256).sum())} blocks "
                 f"ranked by the radix sort): kernel D vs plain: {fmt_cmp(c)}; "
                 f"swept {tiles} CTA tiles, {pairs} pair tests, {touches} "
                 f"any-touch tests, {walked} walk entries")
        check(c["disagree"] == 0 and c["ties"] == 0 and c["err"] == 0.0,
              f"kernel D many tiles: not exact against plain ({fmt_cmp(c)})")
        check(int((counts > 256).sum()) > 0 and c["hits"] > 0.3,
              "kernel D many tiles: no block took the radix sort")
        self.schedule_d(grid, o_t, d_t, None, min_t, rb,
                        f"many tiles ({grid.n_tiles})")
        self.say("7 times", f"many tiles ({grid.n_tiles}) at {n} lanes: kernel D "
                 f"{full_ms:.3f} ms, schedule kernel {sched_ms:.4f} ms, its torch "
                 f"prelude {pre_ms:.3f} ms; the plain sweep {plain_s:.1f} s of "
                 f"wall [{self.card}]")

    def schedule_d(self, grid, o, d, cap, min_t, rb, label):
        """Kernel D's schedule kernel integer-equal to its torch prelude:
        sched, bounds and the real lanes' segment ends."""
        from win32_raytracer_tpu_torch.kernels import tri_grid as KD
        p = KD.prepare(grid, o, d, cap, min_t, rb)
        KD.schedule(p)
        sched, bounds, cap_eff = KD.schedule_plain(grid, o, d, cap, min_t, rb)
        torch.cuda.synchronize()
        n = o.shape[1]
        same = (torch.equal(p.sched, sched) and torch.equal(p.bounds, bounds)
                and torch.equal(p.cap_eff, cap_eff[0, :n]))
        self.say("7 schedule", f"{label}: schedule kernel vs torch prelude: "
                 f"sched, bounds and segment ends {'equal' if same else 'DIFFER'} "
                 f"({sched.shape[0]} blocks, {int(sched[:, 0].sum())} scheduled tiles)")
        check(same, f"kernel D schedule {label}: differs from the torch prelude")

    # ---- phase 8 ----------------------------------------------------------
    def mesh_renders(self):
        """Small mesh renders, kernels against plain; then the triangle
        main paths through the kernels, each with the launch counts set to
        0 just before it: render("mesh") at config 4's size (kernels A and
        C), and config 4 itself, render("mesh20k") (kernels A and D)."""
        import win32_raytracer_tpu_torch.persistent as P
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig

        small = RenderConfig(**SMALL_MESH)
        means = self.small_mesh_means
        for name in ("mesh", "mesh20k"):
            rk = render(name, cfg=small, device=self.dev)
            rp = render(name, cfg=small.replace(backend="jnp"), device=self.dev)
            d = float(np.abs(rk.image.astype(float) - rp.image.astype(float)).mean())
            r = pearson(rk.image, rp.image)
            means[name] = float(rp.image.mean())
            self.say("8 render", f"{name} {small.width}x{small.height}@"
                     f"{small.samples}: kernels vs plain mean |diff| "
                     f"{d:.4f} (<=0.05), pearson r {r:.6f}, means "
                     f"{rk.image.mean():.2f}/{rp.image.mean():.2f}, "
                     f"{rk.duration_ms:.0f} ms vs {rp.duration_ms:.0f} ms")
            check(d <= 0.05, f"{name} small render mean diff {d}")

        cfg = RenderConfig(**CONFIG4)
        sorts = []
        real_sort = P._bin_sort_core

        def counted_sort(*a, **k):
            sorts.append(1)
            return real_sort(*a, **k)
        P._bin_sort_core = counted_sort
        try:
            for name, path in (("mesh", ("hit", "tri", "scatter")),
                               ("mesh20k", ("hit", "tri_grid_sched", "tri_grid",
                                            "scatter"))):
                warm = render(name, cfg=cfg, device=self.dev)
                reset_launches()
                sorts.clear()
                torch.cuda.synchronize()
                res = render(name, cfg=cfg, device=self.dev)
                got = launches()
                mean = float(res.image.mean())
                self.say("8 " + name, f"{name} {cfg.width}x{cfg.height}@"
                         f"{cfg.samples} spp: {res.duration_ms / 1e3:.4f} s "
                         f"(warm run {warm.duration_ms / 1e3:.4f} s), "
                         f"{res.mrays_per_sec:.3f} Mrays/s, image mean {mean:.3f} "
                         f"(small plain {means[name]:.3f}), launches {got}, "
                         f"binned bounces {len(sorts)} [{self.card}]")
                check(res.image.shape == (cfg.height, cfg.width, 3),
                      f"image shape {res.image.shape}")
                check_route(got, path, (), name)
                check(abs(mean - means[name]) <= 3.0,
                      f"{name} image mean {mean} far from the small render's")
                for k in path[1:-1]:
                    self.kernels.setdefault(k, {})["launches"] = got[k]
        finally:
            P._bin_sort_core = real_sort


    # ---- phase 9 ----------------------------------------------------------
    def split_kernels(self):
        """Kernels E (hit + sky) and F (scatter + respawn) against their
        plain versions on random states (a fifth of the lanes dead, every
        material hit; E in each launch form, on the final table and its
        tie, hole and shutter variants; lean and not; F, and kernel B
        beside it, on one camera and on three), then E (each form) and E
        followed by F against kernel B on the headline's chunk of 3,932,160
        lanes, where all three are timed, E in each launch form.  Every
        comparison must be exact: 0 lanes differ, max |err| 0."""
        from win32_raytracer_tpu_torch.animation import orbit_path
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import bounce as B
        from win32_raytracer_tpu_torch.kernels import hit_sky as E
        from win32_raytracer_tpu_torch.kernels import scatter as F
        from win32_raytracer_tpu_torch.persistent import make_dims
        from win32_raytracer_tpu_torch.scene.camera import default_camera

        dev, table = self.dev, self.table
        # Not powers of two; three frames of 69 rows span the 2^18 pixel ids.
        w, h, spp, kpp = 640, 69, 12, 2
        n = 1 << 18
        st = random_state(dev, n, spp // kpp, seed=21)
        cfg = RenderConfig(width=w, height=h, samples=spp, lanes_per_pixel=kpp)
        errs = {"hit_sky": 0.0, "scatter": 0.0}
        # Kernel E in each launch form on the final table and on the
        # variants the packed sweep must get exactly right (a quarter of
        # the rays aimed at the tied rows), dead lanes swept too.
        for kind, tab in variant_tables(table).items():
            stk = st
            if kind != "final":
                d_k = st.direction.clone()
                aim_at_ties(st.origin, d_k, tab, seed=22)
                stk = st._replace(direction=d_k)
            rp, sp = E.hit_sky_plain(tab, stk, cfg=cfg)
            res = {}
            for label, kw in HIT_FORMS:
                rk, sk = E.hit_sky(tab, stk, cfg=cfg, **kw)
                res[label] = exact_cmp(tuple(rk) + tuple(sk), tuple(rp) + tuple(sp))
                errs["hit_sky"] = max(errs["hit_sky"], res[label][1])
            live_hit = (rp.hit & stk.path_alive)[0]
            dead_hit = int((rp.hit & ~stk.path_alive)[0].sum())
            mats = torch.bincount(rp.mat_id[0][live_hit].long(), minlength=3).tolist()
            self.say("9 kernel E", f"{n} random lanes vs the {kind} table "
                     f"({int(stk.path_alive.sum())} live; live hits by material "
                     f"lambertian/metal/dielectric {mats}, dead lanes that hit "
                     f"{dead_hit}): record, radiance and alive vs plain: " + "; ".join(
                         f"{k} {v[0]} lanes differ, max |err| {v[1]:.1e}"
                         for k, v in res.items()))
            for label, (d_e, err_e) in res.items():
                check(d_e == 0 and err_e == 0.0,
                      f"kernel E {label} on {kind}: {d_e} lanes, {err_e}")
            check(min(mats) > 0 and dead_hit > 0, f"a material was not hit: {mats}")
        rk, sk = E.hit_sky(table, st, cfg=cfg)

        cams = {"1 camera": B.pack_camera(default_camera(w, h, device=dev)),
                "3 cameras": B.pack_cameras(orbit_path(n_frames=3, aspect_ratio=w / h,
                                                       device=dev))}
        for lean, extra in ((True, {}),
                            (False, dict(russian_roulette=True,
                                         rr_start_depth=1, stratify=True))):
            cfg = RenderConfig(width=w, height=h, samples=spp,
                               lanes_per_pixel=kpp, **extra)
            dims = make_dims(cfg, w, h, spp, kpp)
            for label, cam_rows in cams.items():
                args = (cam_rows, sk, rk, 0xABC123, 4, dims)
                fk = F.scatter_respawn(*args, cfg=cfg, lean=lean)
                fp = F.scatter_respawn_plain(*args, cfg=cfg, lean=lean)
                bargs = (table, cam_rows, st, 0xABC123, 4, dims)
                bk = B.bounce(*bargs, cfg=cfg, lean=lean)
                bp = B.bounce_plain(*bargs, cfg=cfg, lean=lean)
                res = {"F vs plain": exact_cmp(fk, fp),
                       "B vs plain": exact_cmp(bk, bp),
                       "E then F vs B": exact_cmp(fk, bk)}
                errs["scatter"] = max(errs["scatter"], res["F vs plain"][1])
                self.say("9 kernel F", f"lean={lean}, {label}: " + "; ".join(
                    f"{k} {d} lanes differ, max |err| {e:.3e}"
                    for k, (d, e) in res.items()))
                for k, (d, e) in res.items():
                    check(d == 0 and e == 0.0, f"{k} (lean={lean}, {label}): "
                          f"{d} lanes differ, max |err| {e}")
        del st, rk, sk, rp, sp, fk, fp, bk, bp

        # The headline's chunk: bounces 1 and 2 as kernel B runs them.
        cfg = RenderConfig(**HEADLINE)
        st, dims, cam = fresh_chunk(cfg, dev)
        cam_rows = B.pack_camera(cam)
        n = st.pixel.shape[1]
        state = st
        for step in (1, 2):
            rp, sp = E.hit_sky_plain(table, state, cfg=cfg)
            for label, kw in HIT_FORMS[1:]:
                rk, sk = E.hit_sky(table, state, cfg=cfg, **kw)
                d_e, err_e = exact_cmp(tuple(rk) + tuple(sk), tuple(rp) + tuple(sp))
                check(d_e == 0 and err_e == 0.0,
                      f"kernel E {label} (headline bounce {step}): {d_e} lanes, {err_e}")
            rk, sk = E.hit_sky(table, state, cfg=cfg)
            fk = F.scatter_respawn(cam_rows, sk, rk, 12345, step, dims, cfg=cfg,
                                   lean=True)
            fp = F.scatter_respawn_plain(cam_rows, sk, rk, 12345, step, dims,
                                         cfg=cfg, lean=True)
            bk = B.bounce(table, cam_rows, state, 12345, step, dims, cfg=cfg,
                          lean=True)
            res = {"E vs plain": exact_cmp(tuple(rk) + tuple(sk),
                                           tuple(rp) + tuple(sp)),
                   "F vs plain": exact_cmp(fk, fp),
                   "E then F vs B": exact_cmp(fk, bk)}
            errs["hit_sky"] = max(errs["hit_sky"], res["E vs plain"][1])
            errs["scatter"] = max(errs["scatter"], res["F vs plain"][1])
            self.say("9 headline", f"bounce {step} at {n} lanes: " + "; ".join(
                f"{k} {d} lanes differ, max |err| {e:.3e}"
                for k, (d, e) in res.items()))
            for k, (d, e) in res.items():
                check(d == 0 and e == 0.0,
                      f"{k} (headline bounce {step}): {d} lanes, {e}")
            state = bk
            del rk, sk, rp, sp, fk, fp
        del state, bk

        rk, sk = E.hit_sky(table, st, cfg=cfg)
        live = int(sk.path_alive.sum())
        fargs = (cam_rows, sk, rk, 12345, 1, dims)
        times = {
            "hit_sky": (cuda_ms(lambda: E.hit_sky(table, st, cfg=cfg), 10),
                        cuda_ms(lambda: E.hit_sky_plain(table, st, cfg=cfg), 2)),
            "scatter": (cuda_ms(lambda: F.scatter_respawn(*fargs, cfg=cfg, lean=True), 20),
                        cuda_ms(lambda: F.scatter_respawn_plain(*fargs, cfg=cfg, lean=True), 3)),
        }
        b_ms = cuda_ms(lambda: B.bounce(table, cam_rows, st, 12345, 1, dims,
                                        cfg=cfg, lean=True), 10)
        forms = {label: cuda_ms(lambda: E.hit_sky(table, st, cfg=cfg, **kw), 10)
                 for label, kw in HIT_FORMS[1:]}
        # Bounds on these inputs: E sweeps every active sphere for every
        # lane (53 bytes in, the record, radiance and alive out: 70); F
        # reads 61 bytes of state per lane and the 48-byte record of the
        # live ones, and writes 49 bytes per lane.
        table_bytes = table.attrs.numel() * 4 + table.active.numel()
        bounds = {
            "hit_sky": bound(n * sphere_ops(table),
                             n * (53 + 70) + table_bytes),
            "scatter": bound(live * OPS_SCATTER_LIVE + n * OPS_RESPAWN,
                             n * (61 + 49) + live * 48 + CAM_BYTES),
        }
        for name, (ms, plain) in times.items():
            self.kernels.setdefault(name, {}).update(
                ms=ms, plain_ms=plain, max_abs_err=errs[name],
                bound_ms=bounds[name][0], bound_by=bounds[name][1])
        self.say("9 times", f"at {n} lanes ({live} live after the hit): "
                 f"kernel E {times['hit_sky'][0]:.3f} ms (plain "
                 f"{times['hit_sky'][1]:.3f}, bound {bounds['hit_sky'][0]:.4f} "
                 f"{bounds['hit_sky'][1]}), kernel F {times['scatter'][0]:.3f} ms "
                 f"(plain {times['scatter'][1]:.3f}, bound "
                 f"{bounds['scatter'][0]:.4f} {bounds['scatter'][1]}); E + F "
                 f"{times['hit_sky'][0] + times['scatter'][0]:.3f} ms vs kernel B "
                 f"{b_ms:.3f} ms on the same bounce; kernel E by launch form: "
                 + ", ".join(f"{k} {v:.3f} ms" for k, v in forms.items())
                 + f" [{self.card}]")

    # ---- phase 10 ---------------------------------------------------------
    def kernel_b_multi(self):
        """Kernel B's k-bounce variant (k = 4) at 524,288 lanes, the largest
        batch the below-floor tail hands it (lanes of the headline's chunk
        after two bounces, spread over the image): against four launches
        of kernel B and its plain version, exactly; then on a random state
        with roulette, stratification and three cameras against its plain
        version; timed against four launches of kernel B."""
        from win32_raytracer_tpu_torch.animation import orbit_path
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import bounce as B
        from win32_raytracer_tpu_torch.persistent import (
            _COMPACT_FLOOR, PathState, make_dims)

        dev, table, k = self.dev, self.table, 4
        cfg = RenderConfig(**HEADLINE)
        st, dims, cam = fresh_chunk(cfg, dev)
        cam_rows = B.pack_camera(cam)
        for step in (1, 2):
            st = B.bounce(table, cam_rows, st, 12345, step, dims, cfg=cfg, lean=True)
        m = _COMPACT_FLOOR
        pick = torch.linspace(0, st.pixel.shape[1] - 1, m, device=dev).long()
        sub = PathState(*(x[:, pick].contiguous() for x in st))
        del st
        args = (table, cam_rows, sub, 12345, 3, dims)

        def four_launches():
            s = sub
            for i in range(k):
                s = B.bounce(table, cam_rows, s, 12345, 3 + i, dims, cfg=cfg,
                             lean=True)
            return s

        mk = B.bounce_multi(*args, cfg=cfg, k=k, lean=True)
        mp = B.bounce_multi_plain(*args, cfg=cfg, k=k, lean=True)
        live, s = [], sub
        for i in range(k):
            live.append(int(s.path_alive.sum()))
            s = B.bounce(table, cam_rows, s, 12345, 3 + i, dims, cfg=cfg, lean=True)
        res = {"vs four launches of B": exact_cmp(mk, s),
               "vs plain": exact_cmp(mk, mp)}

        w, h, spp, kpp = 640, 69, 12, 2
        rcfg = RenderConfig(width=w, height=h, samples=spp, lanes_per_pixel=kpp,
                            russian_roulette=True, rr_start_depth=1, stratify=True)
        rst = random_state(dev, 1 << 18, spp // kpp, seed=31)
        rcams = B.pack_cameras(orbit_path(n_frames=3, aspect_ratio=w / h, device=dev))
        rargs = (table, rcams, rst, 0xABC123, 4, make_dims(rcfg, w, h, spp, kpp))
        rp = B.bounce_multi_plain(*rargs, cfg=rcfg, k=k, lean=False)
        res["random, roulette, 3 cameras, vs plain"] = exact_cmp(
            B.bounce_multi(*rargs, cfg=rcfg, k=k, lean=False), rp)
        # The counting form: the same state, and the plain version's counts.
        sk_, sp_ = (torch.zeros(2, dtype=torch.int64, device=dev)
                    for _ in range(2))
        res["roulette with stats, vs plain"] = exact_cmp(
            B.bounce_multi(*rargs, cfg=rcfg, k=k, lean=False, stats=sk_), rp)
        B.bounce_multi_plain(*rargs, cfg=rcfg, k=k, lean=False, stats=sp_)
        self.say("10 kernel B-multi", f"k={k} at {m} lanes (live before each "
                 f"bounce {live}): " + "; ".join(
                     f"{name} {d} lanes differ, max |err| {e:.3e}"
                     for name, (d, e) in res.items())
                 + f"; [live, kills] {sk_.tolist()} (plain {sp_.tolist()})")
        for name, (d, e) in res.items():
            check(d == 0 and e == 0.0, f"kernel B-multi {name}: {d} lanes, {e}")
        check(torch.equal(sk_, sp_) and sk_[1] > 0,
              f"kernel B-multi stats {sk_.tolist()} vs {sp_.tolist()}")

        ms = cuda_ms(lambda: B.bounce_multi(*args, cfg=cfg, k=k, lean=True), 20)
        four = cuda_ms(four_launches, 20)
        plain = cuda_ms(lambda: B.bounce_multi_plain(*args, cfg=cfg, k=k, lean=True), 1)
        b = bound(sum(live) * sphere_ops(table),
                  m * (73 + 61) + table.attrs.numel() * 4 + table.active.numel()
                  + CAM_BYTES)
        self.kernels.setdefault("bounce_multi", {}).update(
            ms=ms, plain_ms=plain, bound_ms=b[0], bound_by=b[1],
            max_abs_err=max(e for _, e in res.values()))
        self.say("10 times", f"k={k} at {m} lanes: kernel B-multi {ms:.3f} ms, "
                 f"four launches of kernel B {four:.3f} ms, plain {plain:.3f} ms, "
                 f"bound {b[0]:.4f} ms ({b[1]}) [{self.card}]")

    # ---- phase 11 ---------------------------------------------------------
    def routes(self):
        """The headline once per route, after small renders of each route
        (160x120, 16 spp, the compaction floor lowered so the route's
        kernels run) that must equal the plain path's image exactly; the
        default headline (kernels B-multi and B below the floor) byte-equal
        to ``multi_backend="xla"``'s (the torch chain there), linear images
        bit-equal, both walls printed; then config 4 with the pallas
        scatter (kernels A, D and F)."""
        import win32_raytracer_tpu_torch.persistent as P
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.scene.builders import get_scene

        small = RenderConfig(**ROUTE_SMALL)
        saved = P._COMPACT_FLOOR
        P._COMPACT_FLOOR = 1 << 14
        try:
            for label, knob, ran, allowed, _ in ROUTES:
                reset_launches()
                rk = render("final", cfg=small.replace(**knob), device=self.dev)
                got = launches()
                rp = render("final", cfg=small.replace(backend="jnp", **knob),
                            device=self.dev)
                d = float(np.abs(rk.image.astype(float) - rp.image.astype(float)).mean())
                self.say("11 small", f"{label} {small.width}x{small.height}@"
                         f"{small.samples}: kernels vs plain "
                         f"mean |diff| {d:.4f} (must be 0), means "
                         f"{rk.image.mean():.3f}/{rp.image.mean():.3f}, "
                         f"launches {got}")
                check(d == 0.0, f"route {label}: small render differs from plain")
                check_route(got, ran, allowed, f"small {label}")
        finally:
            P._COMPACT_FLOOR = saved

        cfg = RenderConfig(**HEADLINE)
        images, walls = {}, {}
        for label, knob, ran, allowed, reports in ROUTES:
            c = cfg.replace(**knob)
            warm = render("final", cfg=c, device=self.dev)
            reset_launches()
            torch.cuda.synchronize()
            res = render("final", cfg=c, device=self.dev)
            got = launches()
            mean = float(res.image.mean())
            self.say("11 " + label, f"final {c.width}x{c.height}@{c.samples} spp: "
                     f"{res.duration_ms / 1e3:.4f} s (warm run "
                     f"{warm.duration_ms / 1e3:.4f} s), {res.mrays_per_sec:.3f} "
                     f"Mrays/s, image mean {mean:.3f} (170.1 +- 1.5), launches "
                     f"{got} [{self.card}]")
            check(res.image.shape == (c.height, c.width, 3),
                  f"image shape {res.image.shape}")
            check_route(got, ran, allowed, label)
            check(abs(mean - HEADLINE_MEAN) <= HEADLINE_MEAN_TOL,
                  f"{label}: headline image mean {mean}")
            if reports:
                self.kernels.setdefault(reports, {})["launches"] = got[reports]
            images[label], walls[label] = res.image, res.duration_ms / 1e3

        # The default tail against the torch chain's, which it must equal.
        scene = get_scene("final", device=self.dev)
        lin = {label: P.render_image_persistent(scene, None,
                                                cfg.replace(**knob))
               for label, knob in (("default", {}),
                                   ("multi_backend=xla",
                                    dict(multi_backend="xla")))}
        same_u8 = bool(np.array_equal(images["default"],
                                      images["multi_backend=xla"]))
        same_lin = bool(torch.equal(lin["default"], lin["multi_backend=xla"]))
        differ = int((images["default"] != images["multi_backend=xla"])
                     .any(-1).sum())
        self.say("11 default vs xla", f"final {cfg.width}x{cfg.height}@"
                 f"{cfg.samples} spp: u8 image byte-equal {same_u8} ({differ} "
                 f"pixels differ), linear image bit-equal {same_lin}; walls "
                 f"default {walls['default']:.4f} s, multi_backend=\"xla\" "
                 f"{walls['multi_backend=xla']:.4f} s [{self.card}]")
        check(same_u8 and same_lin,
              "default headline differs from multi_backend='xla'")
        del lin

        if "mesh20k" not in self.small_mesh_means:
            rp = render("mesh20k", cfg=RenderConfig(**SMALL_MESH, backend="jnp"),
                        device=self.dev)
            self.small_mesh_means["mesh20k"] = float(rp.image.mean())
        c = RenderConfig(**CONFIG4, scatter_backend="pallas")
        warm = render("mesh20k", cfg=c, device=self.dev)
        reset_launches()
        torch.cuda.synchronize()
        res = render("mesh20k", cfg=c, device=self.dev)
        got = launches()
        mean = float(res.image.mean())
        self.say("11 config 4 pallas scatter", f"mesh20k {c.width}x{c.height}@"
                 f"{c.samples} spp: "
                 f"{res.duration_ms / 1e3:.4f} s (warm run "
                 f"{warm.duration_ms / 1e3:.4f} s), {res.mrays_per_sec:.3f} "
                 f"Mrays/s, image mean {mean:.3f} (small plain "
                 f"{self.small_mesh_means['mesh20k']:.3f}), launches {got} "
                 f"[{self.card}]")
        check_route(got, ("hit", "tri_grid_sched", "tri_grid", "scatter"), (),
                    "config 4 pallas scatter")
        check(abs(mean - self.small_mesh_means["mesh20k"]) <= 3.0,
              f"config 4 pallas scatter image mean {mean}")

    def split_scatter(self):
        """Kernel F in every split bounce, above and below the floor:
        ``final`` under ``accel="grid"``, ``mesh`` and ``mesh20k``, at a
        small size and at their cells' sizes (``max_depth`` 10) on one
        shared seed, by default and under ``scatter_backend="jnp"`` (the
        torch scatter).  The linear images must be bit-equal; by default
        kernel F must launch once a split bounce (the recorder's steps
        counters) and ``hash_uniform01`` run only at each batch's first
        respawn (its ``persistent.respawn`` spans), under "jnp" also twice
        a bounce.  Prints the device launches of a render (torch.profiler)
        and the walls of both."""
        import win32_raytracer_tpu_torch.persistent as P
        from torch.profiler import ProfilerActivity, profile
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.scene.builders import get_scene
        from win32_raytracer_tpu_torch.utils import profiling

        real_hash, draws = P.hash_uniform01, []

        def counted_hash(*a, **k):
            draws.append(1)
            return real_hash(*a, **k)

        def run(scene, cfg):
            """(linear image, what one render did)."""
            P.render_image_persistent(scene, None, cfg)
            draws.clear()
            P.hash_uniform01 = counted_hash
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = P.render_image_persistent(scene, None, cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                P.hash_uniform01 = real_hash
            reset_launches()
            with profiling.recording():
                again = P.render_image_persistent(scene, None, cfg)
            log = profiling.log()
            (c,) = log["counters"].values()
            got = launches()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                P.render_image_persistent(scene, None, cfg)
                torch.cuda.synchronize()
            cuda = torch.autograd.DeviceType.CUDA
            return img, dict(
                wall=wall, draws=len(draws), launches=got,
                respawns=sum(s["name"] == "persistent.respawn"
                             for s in log["spans"]),
                bounces=(c.get("persistent.steps_kernel", 0)
                         + c.get("persistent.steps_tail", 0)),
                f_counted=c.get("persistent.scatter_kernel", 0),
                torch_counted=c.get("persistent.scatter_torch", 0),
                device=sum(ev.device_type == cuda for ev in prof.events()),
                repeat=bool(torch.equal(img, again)))

        for label, name, knob in SPLIT_SCENES:
            scene = get_scene(name, device=self.dev)
            for size, dims in (("small", SPLIT_SMALL),
                               ("cell", SPLIT_CELL[name])):
                cfg = RenderConfig(**dims, max_depth=10, seed=SPLIT_SEED,
                                   **knob)
                img, k = run(scene, cfg)
                ref, j = run(scene, cfg.replace(scatter_backend="jnp"))
                same = bool(torch.equal(img, ref))
                self.say("11 split " + label, f"{size} {cfg.width}x{cfg.height}"
                         f"@{cfg.samples}, seed {SPLIT_SEED}: default vs "
                         f"scatter_backend=\"jnp\" linear bit-equal {same}; "
                         f"kernel F launches {k['launches']['scatter']} for "
                         f"{k['bounces']} split bounces (counted "
                         f"{k['f_counted']} / {k['torch_counted']}; jnp "
                         f"{j['launches']['scatter']}, counted {j['f_counted']}"
                         f" / {j['torch_counted']}); hash_uniform01 calls "
                         f"{k['draws']} for {k['respawns']} batch respawns "
                         f"(jnp {j['draws']}); device launches a render "
                         f"{k['device']} (jnp {j['device']}); walls "
                         f"{k['wall']:.4f} s (jnp {j['wall']:.4f} s); repeat "
                         f"bit-equal {k['repeat']}/{j['repeat']} [{self.card}]")
                check(same, f"split {label} {size}: default differs from "
                      "scatter_backend='jnp'")
                check(k["repeat"] and j["repeat"],
                      f"split {label} {size}: a second render differs")
                check(k["bounces"] == j["bounces"] > 0,
                      f"split {label} {size}: bounces {k['bounces']} vs "
                      f"{j['bounces']}")
                check(k["launches"]["scatter"] == k["f_counted"]
                      == k["bounces"] and not k["torch_counted"],
                      f"split {label} {size}: kernel F launches "
                      f"{k['launches']['scatter']}, bounces {k['bounces']}")
                check(j["launches"]["scatter"] == j["f_counted"] == 0
                      and j["torch_counted"] == j["bounces"],
                      f"split {label} {size}: jnp ran kernel F")
                check(k["draws"] == k["respawns"] > 0,
                      f"split {label} {size}: {k['draws']} torch draws for "
                      f"{k['respawns']} respawns")
                check(j["draws"] == j["respawns"] + 2 * j["bounces"],
                      f"split {label} {size}: jnp draws {j['draws']}")
                if name == "final" and size == "cell":
                    self.kernels.setdefault("scatter", {})["launches"] = (
                        k["launches"]["scatter"])

    # ---- phase 12 ---------------------------------------------------------
    def flythrough(self):
        """BASELINE config 5 on one card (bench/configs.py's config 5): the
        final scene over an 8-frame orbit at 640x480, 32 spp, seed 3,
        through render_animation: one batch of 8 frames, kpp 1, 2,457,600
        lanes, so kernel B runs on 8 cameras.  Before it, at 96x64 with
        8 spp (the compaction floor lowered so kernel B runs): the batched
        frames against the plain path's batched frames (identical), and
        against batch_frames=1 (statistically)."""
        import win32_raytracer_tpu_torch.persistent as P
        from win32_raytracer_tpu_torch.animation import (
            _auto_batch_frames, orbit_path, render_animation)
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import bounce as B
        from win32_raytracer_tpu_torch.scene.builders import get_scene

        dev = self.dev
        scene = get_scene("final", device=dev)
        small = RenderConfig(**FLY_SMALL)
        cams = orbit_path(n_frames=8, aspect_ratio=small.width / small.height,
                          device=dev)
        saved = P._COMPACT_FLOOR
        P._COMPACT_FLOOR = 1 << 14
        try:
            reset_launches()
            fk = np.stack(render_animation(scene, cams, small, device=dev))
            got = launches()
            fp = np.stack(render_animation(scene, cams, small.replace(backend="jnp"),
                                           device=dev))
            f1 = np.stack(render_animation(scene, cams, small, batch_frames=1,
                                           device=dev))
        finally:
            P._COMPACT_FLOOR = saved
        d_plain = float(np.abs(fk.astype(float) - fp.astype(float)).mean())
        d1 = float(np.abs(fk.astype(float) - f1.astype(float)).mean())
        r1 = pearson(fk, f1)
        self.say("12 small", f"8 frames {small.width}x{small.height}@"
                 f"{small.samples}: batched kernels vs batched "
                 f"plain mean |diff| {d_plain:.4f} (must be 0), launches {got}; "
                 f"batched vs batch_frames=1 mean |diff| {d1:.3f} "
                 f"(<= {FLY_SMALL_MAX_DIFF}), pearson r {r1:.4f} "
                 f"(>= {FLY_SMALL_MIN_R}), means {fk.mean():.2f}/{f1.mean():.2f}")
        check(d_plain == 0.0, "batched small frames differ from plain")
        check(got["bounce"] > 0, f"kernel B did not run on the small batch: {got}")
        check(d1 <= FLY_SMALL_MAX_DIFF and r1 >= FLY_SMALL_MIN_R,
              f"batched vs unbatched frames: mean |diff| {d1}, r {r1}")

        cfg = RenderConfig(**CONFIG5)
        cams = orbit_path(n_frames=8, aspect_ratio=cfg.width / cfg.height,
                          device=dev)
        kpp = P._resolve_kpp(cfg, cfg.samples, len(cams), cfg.width * cfg.height)
        bf = _auto_batch_frames(cfg, len(cams))
        check((bf, kpp) == (8, 1), f"config 5 batches {bf} frames at kpp {kpp}")
        frames_seen = []
        real = B.bounce

        def spy(table, cam_rows, *a, **k):
            frames_seen.append(B.n_frames_of(cam_rows))
            return real(table, cam_rows, *a, **k)
        render_animation(scene, cams, cfg.replace(seed=cfg.seed + 7001), device=dev)
        reset_launches()
        B.bounce = spy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = render_animation(scene, cams, cfg, device=dev)
            wall = time.perf_counter() - t0
        finally:
            B.bounce = real
        got = launches()
        means = [float(f.mean()) for f in frames]
        rays = cfg.width * cfg.height * cfg.samples * len(cams)
        self.say("12 config 5", f"final, 8 frames {cfg.width}x{cfg.height}@"
                 f"{cfg.samples} spp, one batch of "
                 f"{bf} frames at kpp {kpp} ({bf * kpp * cfg.width * cfg.height} "
                 f"lanes): {wall:.4f} s, {len(frames) / wall:.3f} fps, "
                 f"{rays / wall / 1e6:.3f} Mrays/s, launches {got}, kernel B "
                 f"cameras per launch {sorted(set(frames_seen))}, frame means "
                 f"{[round(x, 2) for x in means]} [{self.card}]")
        check(len(frames) == 8
              and all(f.shape == (cfg.height, cfg.width, 3) for f in frames),
              "config 5 frame shapes")
        check_route(got, ("bounce",), ("bounce_multi",), "config 5")
        check(set(frames_seen) == {8}, f"kernel B cameras {set(frames_seen)}")
        small_means = fk.reshape(8, -1).mean(1)
        self.fly_small_means = small_means.tolist()
        check(all(abs(x - y) <= FLY_MEAN_TOL for x, y in zip(means, small_means)),
              f"config 5 frame means {means} far from the small frames' "
              f"{small_means.tolist()}")


    # ---- phase 13 ---------------------------------------------------------
    def wavefront_kernels(self):
        """Kernels G and H against their plain versions (ops/hit.hit_spheres,
        ops/hit_tri.hit_triangles) on 262,144 random rays (G on the final
        table and its tie, hole and shutter variants; H on the mesh table,
        phase 6's variant tables with aimed rays, its boundary pairs and
        mesh20k's table with the wavefront's rays), then on the
        wavefront's own first and second bounce rays: ``final`` at
        1200x800, 4 spp (one chunk of 3,840,000 lanes; kernel G) and
        ``mesh`` at 800x450, 4 spp (1,440,000 lanes; G on its spheres, H
        on its triangles).  Both kernels in each launch form.  Every
        comparison must be exact: 0 lanes differ (H by every field's bits),
        max |err| 0.  Each kernel is timed on its first-bounce rays, in
        each launch form."""
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.core.rng import fold_in, prng_key
        from win32_raytracer_tpu_torch.kernels import hit_cols as G
        from win32_raytracer_tpu_torch.kernels import tri_cols as H
        from win32_raytracer_tpu_torch.kernels.dispatch import get_hit_fn, hit_tables
        from win32_raytracer_tpu_torch.ops.hit import hit_spheres
        from win32_raytracer_tpu_torch.ops.hit_tri import hit_triangles
        from win32_raytracer_tpu_torch.render import bounce_step, make_primary_rays
        from win32_raytracer_tpu_torch.scene.builders import get_scene
        from win32_raytracer_tpu_torch.scene.camera import default_camera

        dev = self.dev
        kernel = {"hit_cols": (G.hit_spheres_cols, hit_spheres, "G"),
                  "tri_cols": (H.hit_triangles_cols, hit_triangles, "H")}
        errs = {"hit_cols": 0.0, "tri_cols": 0.0}

        def hold(name, tab, o, d, t, what, min_t=RenderConfig().min_hit_t):
            """The kernel against its plain version in each launch form
            (kernel H by every field's bits)."""
            kfn, pfn, letter = kernel[name]
            rp = pfn(tab, o, d, t, min_t=min_t)
            cmp = exact_cmp if name == "hit_cols" else bits_cmp
            res = {label: cmp(rows_of(kfn(tab, o, d, t, min_t, **kw)), rows_of(rp))
                   for label, kw in HIT_FORMS}
            torch.cuda.synchronize()
            self.say(f"13 kernel {letter}", f"{what}: {o.shape[0]} rays, hits "
                     f"{float(rp.hit.float().mean()):.3f}: vs plain " + "; ".join(
                         f"{k} {v[0]} lanes differ, max |err| {v[1]:.3e}"
                         for k, v in res.items()))
            for label, (lanes, err) in res.items():
                check(lanes == 0 and err == 0.0, f"kernel {letter} {label} "
                      f"{what}: {lanes} lanes differ, max |err| {err}")
                errs[name] = max(errs[name], err)

        def cuda_t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=dev).contiguous()

        final = hit_tables(get_scene("final", device=dev))
        mesh = hit_tables(get_scene("mesh", device=dev))
        rng = np.random.default_rng(41)
        n = RANDOM_RAYS
        o = rng.uniform([-12, 0.01, -12], [12, 4, 12], (n, 3))
        o[: n // 3] = [15.0, 2.0, 4.0] + rng.normal(0, 0.3, (n // 3, 3))
        o, d, t = cuda_t(o), cuda_t(rng.normal(0, 1, (n, 3))), cuda_t(rng.uniform(0, 0.05, n))
        for kind, tab in variant_tables(final).items():
            d_k = d.T.contiguous()
            if kind != "final":
                aim_at_ties(o.T, d_k, tab, seed=42)
            hold("hit_cols", tab, o, d_k.T.contiguous(), t, f"random rays vs {kind}")
        o = rng.uniform([-3.0, 0.0, -2.0], [3.0, 3.0, 4.0], (n, 3))
        tgt = np.where(rng.uniform(size=(n, 1)) < 0.8,
                       [0.0, 1.0, 0.0] + rng.normal(0, 0.7, (n, 3)),
                       [0.0, 0.35, 2.2] + rng.normal(0, 0.4, (n, 3)))
        hold("tri_cols", mesh.triangles, cuda_t(o), cuda_t(tgt - o),
             torch.zeros(n, device=dev), "random rays vs mesh")
        # Kernel H on phase 6's tables and boundary pairs, and on mesh20k's
        # 20,492 triangles (81 stages) with 262,144 of the wavefront's rays.
        for kind, tab in tri_variant_tables(mesh.triangles, dev).items():
            o_k, d_k = tri_rays(tab, n, seed=43 + len(kind))
            hold("tri_cols", tab, o_k, d_k, torch.zeros(n, device=dev),
                 f"aimed rays vs the {kind} table")
        for min_t in (RenderConfig().min_hit_t, 0.0):
            groups = self.tri_boundary_groups(min_t, cols=True)
            for tab, o_k, d_k in groups:
                kfn, pfn, _ = kernel["tri_cols"]
                t_k = torch.zeros(o_k.shape[0], device=dev)
                rp = rows_of(pfn(tab, o_k, d_k, t_k, min_t=min_t))
                for label, kw in HIT_FORMS:
                    lanes, e = bits_cmp(rows_of(kfn(tab, o_k, d_k, t_k, min_t, **kw)), rp)
                    check(lanes == 0 and e == 0.0, f"kernel H {label} boundary "
                          f"pairs, min_t {min_t}: {lanes} lanes differ, max |err| {e}")
            self.say("13 kernel H", f"boundary pairs, min_t {min_t}: {len(groups)} "
                     "tables of 32, every form 0 lanes differ")
        cfg = RenderConfig(**WAVEFRONT_MESH)
        w, h, spp = cfg.width, cfg.height, cfg.samples
        st = make_primary_rays(default_camera(w, h, device=dev), 0,
                               fold_in(fold_in(prng_key(0), 0), 1), cfg=cfg,
                               width=w, height=h, spp=spp, rows=h)
        pick = torch.linspace(0, st.origin.shape[0] - 1, n, device=dev).long()
        big = hit_tables(get_scene("mesh20k", device=dev)).triangles
        what = (f"mesh20k ({int(big.active.sum())} triangles, "
                f"{-(-big.attrs.shape[0] // 256)} stages)")
        o20, d20, t20 = (x[pick].contiguous() for x in (st.origin, st.direction, st.time))
        del st
        hold("tri_cols", big, o20, d20, t20, f"{what}, wavefront {w}x{h}@{spp} rays")
        big_ms = {}
        for _ in range(2):   # in turns: R = 1, R = 2, R = 1, R = 2
            for k, kw in HIT_FORMS[1:]:
                big_ms.setdefault(k, []).append(cuda_ms(
                    lambda: H.hit_triangles_cols(big, o20, d20, t20, **kw), 5))
        self.say("13 times", f"kernel H on {what} at {n} wavefront rays by launch "
                 "form, in turns: " + ", ".join(
                     f"{k} " + " / ".join(f"{v:.4f}" for v in vs) + " ms"
                     for k, vs in big_ms.items()) + f" [{self.card}]")
        del o20, d20, t20
        hold("tri_cols", big, *tri_rays(big, n, seed=47), torch.zeros(n, device=dev),
             f"{what}, aimed rays")

        times, bounds, forms_ms = {}, {}, {}
        for name, label, size, tab, sub in (
                ("hit_cols", "final", WAVEFRONT, final, final),
                ("tri_cols", "mesh", WAVEFRONT_MESH, mesh, mesh.triangles)):
            cfg = RenderConfig(**size, backend="jnp")
            w, h, spp = cfg.width, cfg.height, cfg.samples
            key = fold_in(prng_key(0), 0)
            st = make_primary_rays(default_camera(w, h, device=dev), 0,
                                   fold_in(key, 1), cfg=cfg, width=w, height=h,
                                   spp=spp, rows=h)
            plain_fn = get_hit_fn(cfg, dev, tab)
            for bounce in (1, 2):
                what = f"{label} {w}x{h}@{spp} bounce {bounce}"
                hold(name, sub, st.origin, st.direction, st.time, what)
                if label == "mesh":
                    hold("hit_cols", tab.spheres, st.origin, st.direction,
                         st.time, what + " (spheres)")
                if bounce == 1:
                    kfn, pfn, _ = kernel[name]
                    args = (sub, st.origin, st.direction, st.time)
                    times[name] = (cuda_ms(lambda: kfn(*args), 10),
                                   cuda_ms(lambda: pfn(*args), 2))
                    forms_ms[name] = {k: cuda_ms(lambda: kfn(*args, **kw), 10)
                                      for k, kw in HIT_FORMS[1:]}
                    rays = st.origin.shape[0]
                    st = bounce_step(tab, st, fold_in(key, 2), 0, cfg=cfg,
                                     hit_fn=plain_fn)
            # Bounds on these inputs: every ray sweeps every active sphere
            # (triangle); 28 (24) bytes in and the 57-byte record out per
            # ray, and the table once.
            active = int(sub.active.sum())
            table_bytes = sub.attrs.numel() * 4 + sub.active.numel()
            ray_ops, per_ray = ((sphere_ops(sub), 28) if name == "hit_cols"
                                else (active * OPS_TRI_PAIR, 24))
            bounds[name] = bound(rays * ray_ops,
                                 rays * (per_ray + RECORD_BYTES) + table_bytes)
            forms = "; by launch form: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in forms_ms[name].items())
            self.say("13 times", f"kernel {kernel[name][2]} at {rays} rays x "
                     f"{active} {'spheres' if name == 'hit_cols' else 'triangles'}"
                     f": {times[name][0]:.3f} ms, plain {times[name][1]:.3f} ms, "
                     f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}){forms} "
                     f"[{self.card}]")
            del st
        for name in times:
            self.kernels.setdefault(name, {}).update(
                ms=times[name][0], plain_ms=times[name][1],
                max_abs_err=errs[name], bound_ms=bounds[name][0],
                bound_by=bounds[name][1])

    # ---- phase 14 ---------------------------------------------------------
    def wavefront_path(self):
        """The wavefront scheduler through the entry points: small renders
        (48x32, 4 spp: ``test``, ``mesh``; a deterministic specular scene
        at 1 spp) equal to their ``backend="jnp"`` renders; the threefry
        draw kernel bit-equal to core/rng.py's int64 torch ops on the card
        and on the CPU, timed against its bound and those ops at the
        preview's shape; ``render("final")`` at 1200x800, 4 spp through
        kernel G and the draw kernel alone, equal to its plain render, and
        a 300x200 render's mean against the JAX renderer's;
        ``render("mesh")`` at 800x450, 4 spp through G, H and the draw
        kernel; the final scene with ``deterministic=True`` (no draws)
        equal to its plain render; one CLI render in a subprocess."""
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig, resolve_scheduler
        from win32_raytracer_tpu_torch.core.rng import fold_in, prng_key, uniform01
        from win32_raytracer_tpu_torch.kernels import _build
        from win32_raytracer_tpu_torch.kernels import draws as DR
        from win32_raytracer_tpu_torch.io.image import read_image
        from win32_raytracer_tpu_torch.scene.camera import make_camera
        from win32_raytracer_tpu_torch.scene.spheres import SceneBuilder

        dev = self.dev

        def same(a, b) -> float:
            return float(np.abs(a.astype(float) - b.astype(float)).mean())

        b = SceneBuilder()
        b.add_metal((0.0, 0.3, 0.0), 0.8, (0.9, 0.8, 0.7), 0.0)
        b.add_metal((-1.8, 0.2, -0.5), 0.6, (0.6, 0.7, 0.9), 0.0)
        b.add_dielectric((1.7, 0.3, 0.5), 0.6, 1.5)
        b.add_dielectric((1.7, 0.3, 0.5), -0.5, 1.5)
        small = RenderConfig(width=48, height=32, samples=4, seed=2)
        pin = make_camera((0.0, 1.0, 4.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0),
                          45.0, 48 / 32, 0.0, 4.0)
        cases = (("test", "test", None, small, ("hit_cols", "draws")),
                 ("mesh", "mesh", None, small, ("hit_cols", "tri_cols", "draws")),
                 ("specular, deterministic, 1 spp", b.build(), pin,
                  small.replace(samples=1, deterministic=True, reflect_thres=2.0),
                  ("hit_cols",)))
        for label, scene, cam, cfg, ran in cases:
            reset_launches()
            rk = render(scene, cam, cfg, device=dev)
            got = launches()
            rp = render(scene, cam, cfg.replace(backend="jnp"), device=dev)
            d = same(rk.image, rp.image)
            self.say("14 small", f"{label} {cfg.width}x{cfg.height}@{cfg.samples}: "
                     f"kernels vs plain mean |diff| {d:.4f} (must be 0), means "
                     f"{rk.image.mean():.3f}/{rp.image.mean():.3f}, launches {got}")
            check(d == 0.0, f"wavefront small {label}: differs from plain")
            check_route(got, ran, (), f"wavefront small {label}")

        # The draw kernel against the torch version on the card and on the
        # CPU (int32 views), at odd sizes, 2^20 x 5 and the preview's
        # [1,228,800, 5]; then once into an output 4 bytes off 16-byte
        # alignment (the element-wise path of every thread).
        key = fold_in(fold_in(prng_key(7), 480), 2)

        def bits(x):
            return x.reshape(-1).view(torch.int32)
        preview = (PREVIEW_LANES, 5)
        for depth, shape in enumerate(((1,), (7,), (4097,), (5 << 20,), preview)):
            k = fold_in(key, depth)
            got = DR.uniform01(k, shape, dev)
            torch.cuda.synchronize()
            eq_card = torch.equal(bits(got), bits(uniform01(k, shape, device=dev)))
            eq_cpu = torch.equal(bits(got).cpu(), bits(uniform01(k, shape, device="cpu")))
            self.say("14 threefry", f"draw kernel {list(shape)}: bit-equal to the "
                     f"torch ops on the card {eq_card}, on the CPU {eq_cpu}")
            check(eq_card and eq_cpu and got.shape == shape,
                  f"threefry draw kernel {shape} differs from the torch version")
        k, n = fold_in(key, 9), 4097
        buf = torch.zeros(n + 1, dtype=torch.float32, device=dev)
        _build.check(_build.load().wrt_threefry_uniform(
            k[0], k[1], n, buf.data_ptr() + 4, _build.stream_handle(dev)),
            "threefry uniform01 (offset)")
        torch.cuda.synchronize()
        eq_off = bool(buf[0] == 0) and torch.equal(
            bits(buf[1:]).cpu(), bits(uniform01(k, (n,), device="cpu")))
        self.say("14 threefry", f"draw kernel [{n}] into an output 4 bytes off "
                 f"alignment: bit-equal {eq_off}")
        check(eq_off, "threefry draw kernel differs on an unaligned output")

        n = PREVIEW_LANES * 5
        k_ms = cuda_ms(lambda: DR.uniform01(key, preview, dev), 50)
        g_ms = graph_ms(lambda: DR.uniform01(key, preview, dev), 50)
        p_ms = cuda_ms(lambda: uniform01(key, preview, device=dev), 5)
        b_ms, b_by = bound(n * OPS_THREEFRY, n * 4, peak_ops=PEAK_INT32)
        self.say("14 threefry", f"one {list(preview)} draw (the preview's): kernel "
                 f"{k_ms:.4f} ms (card time, CUDA graph {g_ms:.4f}), bound "
                 f"{b_ms:.4f} ms by {b_by} ({OPS_THREEFRY} integer operations an "
                 f"element at {PEAK_INT32 / 1e12:.1f} T/s; 4 bytes at "
                 f"{PEAK_BYTES / 1e12:.2f} TB/s), {100 * b_ms / g_ms:.1f}% of it; "
                 f"the torch int64 ops {p_ms:.3f} ms [{self.card}]")
        self.kernels.setdefault("draws", {}).update(
            max_abs_err=0.0, ms=round(g_ms, 4), plain_ms=round(p_ms, 3),
            bound_ms=round(b_ms, 4), bound_by=b_by)

        cfg = RenderConfig(**WAVEFRONT)
        check(resolve_scheduler(cfg) == "wavefront", "final at 4 spp: not the wavefront")
        warm = render("final", cfg=cfg, device=dev)
        reset_launches()
        torch.cuda.synchronize()
        res = render("final", cfg=cfg, device=dev)
        got = launches()
        plain = render("final", cfg=cfg.replace(backend="jnp"), device=dev)
        d = same(res.image, plain.image)
        self.say("14 final", f"final {cfg.width}x{cfg.height}@{cfg.samples} spp, "
                 f"wavefront: {res.duration_ms / 1e3:.4f} s (warm run "
                 f"{warm.duration_ms / 1e3:.4f} s), {res.mrays_per_sec:.3f} "
                 f"Mrays/s, image mean {res.image.mean():.3f}, launches {got}; "
                 f"vs plain render ({plain.duration_ms / 1e3:.3f} s) mean |diff| "
                 f"{d:.4f} (must be 0) [{self.card}]")
        check(res.image.shape == (cfg.height, cfg.width, 3), "final image shape")
        check(got["hit_cols"] == cfg.max_depth + 1,
              f"kernel G launches {got['hit_cols']}, expected {cfg.max_depth + 1}")
        check(got["draws"] == cfg.max_depth + 2,
              f"draw kernel launches {got['draws']}, expected {cfg.max_depth + 2}")
        check_route(got, ("hit_cols", "draws"), (), "final wavefront")
        check(d == 0.0, "final wavefront render differs from its plain render")
        self.kernels.setdefault("hit_cols", {})["launches"] = got["hit_cols"]
        self.kernels.setdefault("draws", {})["launches"] = got["draws"]

        small_res = render("final", cfg=RenderConfig(**WAVEFRONT_SMALL), device=dev)
        mean = float(small_res.image.mean())
        self.say("14 final", f"final 300x200@4 image mean {mean:.3f} (JAX "
                 f"renderer {WAVEFRONT_SMALL_MEAN} +- {WAVEFRONT_SMALL_TOL})")
        check(abs(mean - WAVEFRONT_SMALL_MEAN) <= WAVEFRONT_SMALL_TOL,
              f"final 300x200 mean {mean}")

        cfg = RenderConfig(**WAVEFRONT_MESH)
        warm = render("mesh", cfg=cfg, device=dev)
        reset_launches()
        torch.cuda.synchronize()
        res = render("mesh", cfg=cfg, device=dev)
        got = launches()
        plain = render("mesh", cfg=cfg.replace(backend="jnp"), device=dev)
        d = same(res.image, plain.image)
        self.say("14 mesh", f"mesh {cfg.width}x{cfg.height}@{cfg.samples} spp, "
                 f"wavefront: {res.duration_ms / 1e3:.4f} s (warm run "
                 f"{warm.duration_ms / 1e3:.4f} s), {res.mrays_per_sec:.3f} "
                 f"Mrays/s, image mean {res.image.mean():.3f}, launches {got}; "
                 f"vs plain mean |diff| {d:.4f} (must be 0) [{self.card}]")
        want = {"hit_cols": cfg.max_depth + 1, "tri_cols": cfg.max_depth + 1,
                "draws": cfg.max_depth + 2}
        check({k: got[k] for k in want} == want, f"mesh launches {got}")
        check_route(got, ("hit_cols", "tri_cols", "draws"), (), "mesh wavefront")
        check(d == 0.0, "mesh wavefront render differs from its plain render")
        self.kernels.setdefault("tri_cols", {})["launches"] = got["tri_cols"]

        cfg = RenderConfig(**WAVEFRONT, deterministic=True)
        reset_launches()
        rk = render("final", cfg=cfg, device=dev)
        got = launches()
        rp = render("final", cfg=cfg.replace(backend="jnp"), device=dev)
        d = same(rk.image, rp.image)
        check_route(got, ("hit_cols",), (), "deterministic final")
        self.say("14 deterministic", f"final {cfg.width}x{cfg.height}@"
                 f"{cfg.samples}, deterministic: {rk.duration_ms / 1e3:.4f} s, "
                 f"mean {rk.image.mean():.3f}; vs plain mean |diff| {d:.4f} "
                 f"(must be 0)")
        check(d == 0.0, "deterministic final differs from its plain render")

        root = os.path.dirname(os.path.abspath(__file__))
        out = os.path.join(root, "out", "chip_smoke_cli.bmp")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        if os.path.exists(out):
            os.remove(out)
        cmd = [sys.executable, "-m", "win32_raytracer_tpu_torch.cli", "96", "64",
               "4", "--scene", "test", "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                              timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
        img = read_image(out)
        want_img = render("test", cfg=RenderConfig(width=96, height=64, samples=4),
                          device=dev).image
        self.say("14 cli", f"{' '.join(cmd[1:4])} ... in {wall:.2f} s (process "
                 f"included): {' | '.join(proc.stderr.strip().splitlines())}; "
                 f"BMP {img.shape}, equal to api.render's image: "
                 f"{bool(np.array_equal(img, want_img))}")
        check(img.shape == (64, 96, 3), f"CLI image shape {img.shape}")
        check(np.array_equal(img, want_img), "CLI image differs from api.render's")

    # ---- phase 15 ---------------------------------------------------------
    def kernel_i(self):
        """Kernel I (the sphere grid's pass B and merge) against its plain
        grid sweep, in rows and in columns: random primary-like and
        clustered-bounce batches (tests/test_hit_grid_rows.py's), the final
        scene with a sixth of its spheres inactive, and the headline's own
        first and second bounce rays under accel="grid" (3,932,160 lanes).
        Every comparison must be exact: 0 lanes differ, max |err| 0.  Also
        kernel I against kernel A (the brute sweep), winner disagreements
        counted apart from exact-t ties; the schedule kernel's schedule and
        pass A equal to their plain version on every input, in both
        layouts; grids of 257 and 1,000 globals (many_globals); the three
        experimental adapters against their plain versions; times of both launches, each alone and the schedule's
        plain version, and bounds from the pair tests the sweep's stats
        count and pass A's."""
        from win32_raytracer_tpu_torch.accel import (
            build_grid_accel, hit_spheres_grid_plain, hit_spheres_grid_rows_plain)
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import hit as K
        from win32_raytracer_tpu_torch.kernels import hit_grid as KI
        from win32_raytracer_tpu_torch.kernels.dispatch import get_hit_fn_rows_accel
        from win32_raytracer_tpu_torch.kernels.experimental import (
            hit_pallas_v1, hit_pallas_v2, hit_pallas_v5)
        from win32_raytracer_tpu_torch.kernels.experimental.hit_grid import (
            hit_spheres_grid_pallas)
        from win32_raytracer_tpu_torch.ops.hit import hit_spheres, sphere_table
        from win32_raytracer_tpu_torch.persistent import p_bounce_step
        from win32_raytracer_tpu_torch.scene.builders import get_scene

        dev = self.dev
        cfg = RenderConfig(**HEADLINE, accel="grid", backend="jnp")
        final = get_scene("final", device=dev)
        gscene, plain_fn = get_hit_fn_rows_accel(cfg, final)
        table = sphere_table(final)
        err = 0.0

        def hold(g, tab, o, d, t, what, stats=None):
            """Kernel I in rows and in columns against the plain grid sweep,
            then against kernel A; returns the rows record."""
            nonlocal err
            rk = KI.hit_spheres_grid_rows(g, o, d, t, stats=stats)
            rp = hit_spheres_grid_rows_plain(g, o, d, t)
            oc, dc = o.T.contiguous(), d.T.contiguous()
            ck = KI.hit_spheres_grid_cols(g, oc, dc, t[0].contiguous())
            cp = hit_spheres_grid_plain(g, oc, dc, t[0].contiguous())
            torch.cuda.synchronize()
            lanes, e = exact_cmp(tuple(rk), tuple(rp))
            lanes_c, e_c = exact_cmp(rows_of(ck), rows_of(cp))
            lanes_rc, _ = exact_cmp(tuple(rk), rows_of(ck))
            err = max(err, e, e_c)
            brute = K.hit_spheres_rows(tab, o, d, t)
            hk, hb = rk.hit[0], brute.hit[0]
            diff = (hk != hb) | (hk & hb & (rk.idx[0] != brute.idx[0]))
            ties = diff & hk & hb & (rk.t[0] == brute.t[0])
            real = int((diff & ~ties).sum())
            self.say("15 kernel I", f"{what}: {o.shape[1]} rays, hits "
                     f"{float(rp.hit.float().mean()):.3f}: rows {lanes} lanes "
                     f"differ from plain (max |err| {e:.3e}), columns {lanes_c} "
                     f"(max |err| {e_c:.3e}), rows vs columns {lanes_rc}; vs "
                     f"kernel A (brute): {real} disagreements, {int(ties.sum())} "
                     f"exact-t ties")
            check(lanes == 0 and e == 0.0 and lanes_c == 0 and e_c == 0.0
                  and lanes_rc == 0,
                  f"kernel I {what}: {lanes}/{lanes_c}/{lanes_rc} lanes differ")
            check(real == 0, f"kernel I {what}: {real} disagreements with the brute sweep")
            for cols in (False, True):
                self.schedule_i(g, *((oc, dc, t[0].contiguous()) if cols else (o, d, t)),
                                cfg.min_hit_t, 2048, cols, what)
            return rk

        def cuda_t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=dev).contiguous()

        rng = np.random.default_rng(51)
        n, rb = 1 << 19, 2048
        o = np.tile([15.0, 2.0, 4.0], (n, 1)) + rng.normal(0, 0.05, (n, 3))
        d = rng.uniform([-12, 0, -12], [12, 2.5, 12], (n, 3)) - o
        batches = {"primary-like": (o, d)}
        centers = rng.uniform([-11, 0.0, -11], [11, 0.4, 11], (n // rb, 3))
        o = (np.repeat(centers, rb, axis=0)
             + rng.uniform(-0.5, 0.5, (n, 3)) * [1.0, 0.4, 1.0])
        batches["clustered bounce"] = (o, rng.normal(0, 0.55, (n, 3)) + [0.0, 1.0, 0.0])
        tm = cuda_t(rng.uniform(0, 0.05, (1, n)))
        for label, (o, d) in batches.items():
            d = d / np.linalg.norm(d, axis=1, keepdims=True)
            hold(gscene, table, cuda_t(o.T), cuda_t(d.T), tm, f"random {label}")
        act = final.active.clone()
        act[torch.nonzero(act)[::6, 0]] = False
        thin = final._replace(active=act)
        o, d = batches["clustered bounce"]
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        hold(build_grid_accel(thin, time_hi=0.05), sphere_table(thin),
             cuda_t(o.T), cuda_t(d.T), tm, "a sixth of the spheres inactive")

        # The headline's chunk: the rays of bounces 1 and 2 (the plain grid
        # bounce between them), with kernel I's tile and pair counts.
        st, dims, cam = fresh_chunk(cfg, dev)
        lanes = st.pixel.shape[1]
        work, times, rays = {}, {}, {}
        for bounce in (1, 2):
            o, d, t = (x.contiguous() for x in (st.origin, st.direction, st.time))
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            hold(gscene, table, o, d, t, f"headline bounce {bounce}", stats)
            tiles, pairs = (int(x) for x in stats.cpu())
            work[bounce] = pairs
            rays[bounce] = (o, d, t)
            per_cta = KI.SWEEP_LANES_PER_CTA
            ctas = lanes // rb * -(-rb // per_cta)
            self.say("15 kernel I", f"headline bounce {bounce}: {tiles} CTA "
                     f"tiles ({tiles / ctas:.1f} per CTA of {ctas}, each a "
                     f"schedule entry walked and staged), {pairs} pair tests, "
                     f"{pairs / lanes:.1f} per ray, {pairs / max(tiles, 1) / per_cta:.1f} "
                     f"per lane and staged tile (brute: {int(table.active.sum())})")
            if bounce == 1:
                st = p_bounce_step(gscene, cam, st, 12345, 1, dims, cfg=cfg,
                                   hit_fn=plain_fn, lean=True)
        del st
        pair_ops = sphere_ops(table) / int(table.active.sum())   # per pair test
        n_glob = gscene.glob_active
        fn_bytes = (lanes * (28 + RECORD_BYTES) + gscene.tile_attrs.numel() * 4
                    + gscene.glob_attrs.numel() * 4 + gscene.tile_boxes.numel() * 4)
        sched_bytes = (lanes * (28 + RECORD_BYTES) + gscene.glob_attrs.numel() * 4
                       + gscene.tile_boxes.numel() * 4
                       + (lanes // rb) * (1 + gscene.n_tiles) * 4)
        pass_a_ops = lanes * n_glob * OPS_SPHERE_PAIR
        sb = bound(pass_a_ops + lanes * OPS_FOOTPRINT, sched_bytes)
        for bounce, (o, d, t) in rays.items():
            full = cuda_ms(lambda: KI.hit_spheres_grid_rows(gscene, o, d, t), 10)
            p = KI.prepare(gscene, o, d, t, cfg.min_hit_t, rb, False)
            sched_ms = cuda_ms(lambda: KI.schedule(p), 20)
            alone = cuda_ms(lambda: KI.launch(p), 20)
            pre = cuda_ms(lambda: KI.schedule_plain(gscene, o, d, t, cfg.min_hit_t,
                                                    rb, False), 2)
            plain = cuda_ms(lambda: hit_spheres_grid_rows_plain(gscene, o, d, t), 1)
            brute = cuda_ms(lambda: K.hit_spheres_rows(table, o, d, t), 5)
            b = bound(work[bounce] * pair_ops + pass_a_ops + lanes * OPS_FOOTPRINT,
                      fn_bytes)
            times[bounce] = (full, plain, b, sched_ms, pre)
            self.say("15 times", f"headline bounce {bounce} at {lanes} rays: "
                     f"kernel I {full:.3f} ms, both launches (schedule kernel "
                     f"{sched_ms:.4f} ms, bound {sb[0]:.4f} ms ({sb[1]}), its plain "
                     f"version {pre:.3f} ms; sweep alone {alone:.3f} ms), plain "
                     f"{plain:.3f} ms, bound {b[0]:.4f} ms ({b[1]}); kernel A "
                     f"(brute) on the same rays {brute:.3f} ms [{self.card}]")
        # The kernels line reports the second bounce (a typical mid-path
        # bounce: origins on the geometry, blocks still pixel-coherent).
        full, plain, b, sched_ms, pre = times[2]
        self.kernels.setdefault("hit_grid", {}).update(
            ms=full, plain_ms=plain, max_abs_err=err, bound_ms=b[0],
            bound_by=b[1])
        self.kernels.setdefault("hit_grid_sched", {}).update(
            ms=sched_ms, plain_ms=pre, max_abs_err=0.0, bound_ms=sb[0],
            bound_by=sb[1])
        # The column instance (the experimental hit_grid's) on bounce 2.
        oc, dc, tc = (x.T.contiguous() if x.shape[0] == 3 else x[0].contiguous()
                      for x in rays[2])
        full_c = cuda_ms(lambda: hit_spheres_grid_pallas(gscene, oc, dc, tc), 10)
        plain_c = cuda_ms(lambda: hit_spheres_grid_plain(gscene, oc, dc, tc), 1)
        pc = KI.prepare(gscene, oc, dc, tc, cfg.min_hit_t, rb, True)
        sched_c = cuda_ms(lambda: KI.schedule(pc), 20)
        self.say("15 times", f"column instance (hit_spheres_grid_pallas) on "
                 f"headline bounce 2: {full_c:.3f} ms, both launches (schedule "
                 f"kernel {sched_c:.4f} ms), plain {plain_c:.3f} ms, bound "
                 f"{b[0]:.4f} ms ({b[1]}) [{self.card}]")

        self.many_globals(hold)

        # The experimental adapters on one random batch each.
        m = 1 << 18
        o = cuda_t(rng.uniform([-12, 0.01, -12], [12, 4, 12], (m, 3)))
        d = cuda_t(rng.normal(0, 1, (m, 3)))
        t = cuda_t(rng.uniform(0, 0.05, m))
        res = {"v1 (kernel G)": (hit_pallas_v1.hit_spheres_pallas(table, o, d, t),
                                 hit_spheres(table, o, d, t)),
               "v2 (kernel G)": (hit_pallas_v2.hit_spheres_pallas_v2(table, o, d, t),
                                 hit_spheres(table, o, d, t))}
        o5, d5, t5 = o.T.contiguous(), d.T.contiguous(), t[None].contiguous()
        rk = hit_pallas_v5.hit_spheres_pallas_v5(table, o5, d5, t5)
        rp = K.hit_spheres_rows_plain(table, o5, d5, t5)
        torch.cuda.synchronize()
        out = {k: exact_cmp(rows_of(a), rows_of(b)) for k, (a, b) in res.items()}
        out["v5 (kernel A)"] = exact_cmp(tuple(rk), tuple(rp))
        self.say("15 adapters", f"{m} random rays vs final: " + "; ".join(
            f"{k} {dl} lanes differ from plain, max |err| {e:.3e}"
            for k, (dl, e) in out.items()))
        for k, (dl, e) in out.items():
            check(dl == 0 and e == 0.0, f"adapter {k}: {dl} lanes differ, {e}")
        b = bound(m * sphere_ops(table),
                  m * (28 + RECORD_BYTES) + table.attrs.numel() * 4 + table.active.numel())
        t_ad = {
            "v1": (cuda_ms(lambda: hit_pallas_v1.hit_spheres_pallas(table, o, d, t), 10),
                   cuda_ms(lambda: hit_spheres(table, o, d, t), 2)),
            "v2": (cuda_ms(lambda: hit_pallas_v2.hit_spheres_pallas_v2(table, o, d, t), 10),
                   cuda_ms(lambda: hit_spheres(table, o, d, t), 2)),
            "v5": (cuda_ms(lambda: hit_pallas_v5.hit_spheres_pallas_v5(table, o5, d5, t5), 10),
                   cuda_ms(lambda: K.hit_spheres_rows_plain(table, o5, d5, t5), 2))}
        self.say("15 times", f"adapters at {m} rays x {int(table.active.sum())} "
                 "spheres: " + "; ".join(
            f"{k} {ms:.3f} ms (plain {pl:.3f})" for k, (ms, pl) in t_ad.items())
            + f"; bound {b[0]:.4f} ms ({b[1]}) [{self.card}]")

    def many_globals(self, hold):
        """Kernel I on grids of 257 and 1,000 globals (spheres above 3x the
        median radius: pass A over two and four stages of 256 rows): rows
        and columns exact against the plain grid sweep on 262,144 rays
        over the scene (MANY_GLOBAL_RAYS), pass A and the schedule equal to their plain
        version (``hold``); then a small accel="grid" render through the
        entry point equal to its plain render, through both launches."""
        from win32_raytracer_tpu_torch.accel import build_grid_accel
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import hit_grid as KI
        from win32_raytracer_tpu_torch.ops.hit import sphere_table

        dev = self.dev
        for n_big in (257, 1000):
            scene = many_globals_scene(n_big, dev)
            g = build_grid_accel(scene, time_hi=0.05)
            n_glob = int((g.glob_attrs[:, 8] != 0).sum())
            check(n_glob == n_big and g.glob_attrs.shape[0] > 256,
                  f"many globals: {n_glob} globals in {g.glob_attrs.shape[0]} rows")
            rng = np.random.default_rng(n_big)
            n = MANY_GLOBAL_RAYS
            h = n // 2
            o = np.concatenate([
                np.tile([40.0, 6.0, 40.0], (h, 1)) + rng.normal(0, 0.05, (h, 3)),
                rng.uniform([-30, 0.05, -30], [30, 1.0, 30], (n - h, 3))])
            d = np.concatenate([
                rng.uniform([-30, 0, -30], [30, 1.5, 30], (h, 3)) - o[:h],
                rng.normal(0, 0.55, (n - h, 3)) + [0.0, 0.6, 0.0]])
            o_t, d_t = (torch.as_tensor(x.T, dtype=torch.float32, device=dev).contiguous()
                        for x in (o, d))
            t_t = torch.as_tensor(rng.uniform(0, 0.05, (1, n)), dtype=torch.float32,
                                  device=dev)
            label = f"{n_glob} globals ({g.glob_attrs.shape[0]} rows, {g.n_tiles} tiles)"
            hold(g, sphere_table(scene), o_t, d_t, t_t, label)
            ms = cuda_ms(lambda: KI.hit_spheres_grid_rows(g, o_t, d_t, t_t), 10)
            self.say("15 times", f"{label} at {n} rays: kernel I {ms:.3f} ms, "
                     f"both launches [{self.card}]")
            cfg = RenderConfig(**ROUTE_SMALL, accel="grid")
            reset_launches()
            rk = render(scene, cfg=cfg, device=dev)
            got = launches()
            rp = render(scene, cfg=cfg.replace(backend="jnp"), device=dev)
            diff = float(np.abs(rk.image.astype(float) - rp.image.astype(float)).mean())
            self.say("15 many globals", f"{label}: render {cfg.width}x{cfg.height}@"
                     f"{cfg.samples} accel=grid vs plain mean |diff| {diff:.4f} "
                     f"(must be 0), mean {rk.image.mean():.3f}, launches {got}")
            check(diff == 0.0, f"{label}: grid render differs from plain")
            check_route(got, GRID_SPLIT, (), f"grid render, {label}")

    def schedule_i(self, g, o, d, t, min_t, rb, cols, what):
        """Kernel I's schedule kernel integer-equal to its plain version:
        the schedule, and pass A's t and original index on every lane."""
        from win32_raytracer_tpu_torch.kernels import hit_grid as KI
        p = KI.prepare(g, o, d, t, min_t, rb, cols)
        KI.schedule(p)
        t_a, i_a, sched = KI.schedule_plain(g, o, d, t, min_t, rb, cols)
        torch.cuda.synchronize()
        n = p.n
        hit = t_a[:n] < 1e30
        idx = torch.where(hit, g.glob_attrs[i_a[:n].clamp_min(0), 15].to(torch.int32), 0)
        rec_t = p.rec.t if cols else p.rec.t[0]
        rec_i = p.rec.idx if cols else p.rec.idx[0]
        same = (torch.equal(p.sched, sched) and torch.equal(rec_t, t_a[:n])
                and torch.equal(rec_i, idx))
        self.say("15 schedule", f"{what} ({'columns' if cols else 'rows'}): "
                 f"schedule kernel vs plain: schedule and pass A "
                 f"{'equal' if same else 'DIFFER'} ({sched.shape[0]} blocks, "
                 f"{int(sched[:, 0].sum())} scheduled tiles)")
        check(same, f"kernel I schedule {what}: differs from its plain version")

    # ---- phase 16 ---------------------------------------------------------
    def grid_path(self):
        """The sphere grid through the entry points: small ``final`` renders
        with accel="grid" (160x120, 16 spp; the one-shot tail, then the
        compaction floor lowered so bounces above it run; once more with
        ray_binning="on") equal to their backend="jnp" renders; the
        headline with accel="grid" (kernel I's schedule kernel and sweep on
        every bounce, no kernel A, B, B-multi or E); one small render through
        each experimental adapter as an explicit hit_fn on the persistent
        scheduler, equal to the same render through its plain
        counterpart."""
        import win32_raytracer_tpu_torch.persistent as P
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.accel import (
            build_grid_accel, hit_spheres_grid_plain)
        from win32_raytracer_tpu_torch.kernels.experimental.hit_grid import (
            hit_spheres_grid_pallas)
        from win32_raytracer_tpu_torch.kernels.experimental.hit_pallas_v1 import (
            hit_spheres_pallas)
        from win32_raytracer_tpu_torch.kernels.experimental.hit_pallas_v2 import (
            hit_spheres_pallas_v2)
        from win32_raytracer_tpu_torch.kernels.experimental.hit_pallas_v5 import (
            hit_spheres_pallas_v5)
        from win32_raytracer_tpu_torch.kernels.hit import hit_spheres_rows_plain
        from win32_raytracer_tpu_torch.ops.hit import hit_spheres
        from win32_raytracer_tpu_torch.persistent import render_image_persistent
        from win32_raytracer_tpu_torch.render import render as render_scene, tonemap
        from win32_raytracer_tpu_torch.scene.builders import get_scene
        from win32_raytracer_tpu_torch.scene.camera import default_camera

        dev = self.dev
        small = RenderConfig(**ROUTE_SMALL, accel="grid")
        saved = P._COMPACT_FLOOR
        try:
            for label, floor, knob in (
                    ("one-shot tail", saved, {}),
                    ("compaction, bounces above the floor", 1 << 14, {}),
                    ("ray_binning=on", 1 << 14, dict(ray_binning="on"))):
                P._COMPACT_FLOOR = floor
                reset_launches()
                rk = render("final", cfg=small.replace(**knob), device=dev)
                got = launches()
                rp = render("final", cfg=small.replace(backend="jnp", **knob),
                            device=dev)
                d = float(np.abs(rk.image.astype(float) - rp.image.astype(float)).mean())
                self.say("16 small", f"grid {label} {small.width}x{small.height}@"
                         f"{small.samples}: kernels vs plain mean |diff| {d:.4f} "
                         f"(must be 0), means {rk.image.mean():.3f}/"
                         f"{rp.image.mean():.3f}, launches {got}")
                check(d == 0.0, f"grid {label}: small render differs from plain")
                check_route(got, GRID_SPLIT, (), f"small grid {label}")
                check(got["hit_grid_sched"] == got["hit_grid"],
                      f"grid {label}: schedule {got['hit_grid_sched']} vs "
                      f"sweep {got['hit_grid']} launches")
        finally:
            P._COMPACT_FLOOR = saved

        cfg = RenderConfig(**HEADLINE, accel="grid")
        warm = render("final", cfg=cfg, device=dev)
        reset_launches()
        torch.cuda.synchronize()
        res = render("final", cfg=cfg, device=dev)
        got = launches()
        mean = float(res.image.mean())
        self.say("16 headline grid", f"final {cfg.width}x{cfg.height}@"
                 f"{cfg.samples} spp, accel=grid: {res.duration_ms / 1e3:.4f} s "
                 f"(warm run {warm.duration_ms / 1e3:.4f} s), "
                 f"{res.mrays_per_sec:.3f} Mrays/s, image mean {mean:.3f} "
                 f"(170.1 +- 1.5), launches {got} [{self.card}]")
        check(res.image.shape == (800, 1200, 3), f"image shape {res.image.shape}")
        check_route(got, GRID_SPLIT, (), "headline grid")
        check(got["hit_grid_sched"] == got["hit_grid"],
              f"headline grid: schedule {got['hit_grid_sched']} vs sweep "
              f"{got['hit_grid']} launches")
        check(abs(mean - HEADLINE_MEAN) <= HEADLINE_MEAN_TOL,
              f"headline grid image mean {mean}")
        for k in GRID_ROUTE:
            self.kernels.setdefault(k, {})["launches"] = got[k]

        # Explicit hit functions on the persistent scheduler: the column
        # adapters through render(hit_fn=...) (v1, v2 on kernel G; the
        # column grid, on kernels G and I, over the GridScene), the rows
        # adapter v5 (kernel A) through render_image_persistent; each equal
        # to the same render through its plain counterpart.
        scene = get_scene("final", device=dev)
        c = RenderConfig(**ROUTE_SMALL, scheduler="persistent")
        cam = default_camera(c.width, c.height, device=dev)
        gscene = build_grid_accel(scene, time_hi=float(cam.shutter_close))

        def rows_render(sc, fn):
            return tonemap(render_image_persistent(sc, cam, c, hit_fn=fn)).cpu().numpy()
        cases = (
            ("v1", lambda: render_scene(scene, cam, c, hit_fn=hit_spheres_pallas),
             lambda: render_scene(scene, cam, c, hit_fn=hit_spheres),
             ("hit_cols", "scatter")),
            ("v2", lambda: render_scene(scene, cam, c, hit_fn=hit_spheres_pallas_v2),
             lambda: render_scene(scene, cam, c, hit_fn=hit_spheres),
             ("hit_cols", "scatter")),
            ("v5", lambda: rows_render(scene, hit_spheres_pallas_v5),
             lambda: rows_render(scene, hit_spheres_rows_plain), ("hit", "scatter")),
            ("hit_grid", lambda: render_scene(gscene, cam, c, hit_fn=hit_spheres_grid_pallas),
             lambda: render_scene(gscene, cam, c, hit_fn=hit_spheres_grid_plain),
             GRID_SPLIT))
        for label, run, plain, ran in cases:
            reset_launches()
            t0 = time.perf_counter()
            img = run()
            wall = time.perf_counter() - t0
            got = launches()
            d = float(np.abs(img.astype(float) - plain().astype(float)).mean())
            self.say("16 hit_fn", f"final {c.width}x{c.height}@{c.samples}, "
                     f"persistent, hit_fn={label} adapter: {wall:.3f} s, mean "
                     f"{img.mean():.3f}, launches {got}; vs its plain "
                     f"counterpart mean |diff| {d:.4f} (must be 0)")
            check(d == 0.0, f"hit_fn={label}: render differs from plain")
            check_route(got, ran, (), f"render(hit_fn={label} adapter)")

    # ---- phase 18 ---------------------------------------------------------
    def knobs(self):
        """The persistent scheduler's opt-in knobs on the headline: the
        route compactor against the sort compactor on the headline's state
        at its first above-floor compaction; the window flush and the
        run-sum flush against ``index_add_`` on the headline's dropped
        tails with TF32 matmuls allowed; ``p_render_until`` against
        successive ``p_bounce_step`` calls on the staged tail's first
        stage; the per-pixel accounting of a receiver event; then each
        knob's full headline (mean, launches, wall, host reads,
        compaction time)."""
        import win32_raytracer_tpu_torch.persistent as P
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig

        cfg = RenderConfig(**HEADLINE)
        kpp = P._resolve_kpp(cfg, cfg.samples)
        caught = {}
        real_compact, real_until = P._compact, P.p_render_until

        def clone_state(st):
            return P.PathState(*(x.clone() for x in st))

        def catch_compact(st, accum, **k):
            key = "above" if k.get("tail_sorted") else "below"
            if key not in caught:
                caught[key] = (clone_state(st), accum.clone(), dict(k))
            return real_compact(st, accum, **k)

        def catch_until(*a, **k):
            if "until" not in caught:
                caught["until"] = (a[:2] + (clone_state(a[2]),) + a[3:], dict(k))
            return real_until(*a, **k)

        P._compact, P.p_render_until = catch_compact, catch_until
        try:
            render("final", cfg=cfg.replace(one_shot="staged"), device=self.dev)
        finally:
            P._compact, P.p_render_until = real_compact, real_until
        check({"above", "below", "until"} <= set(caught),
              f"the headline's events not all seen: {sorted(caught)}")
        self.route_vs_sort(P, *caught["above"], kpp)
        self.flushes(P, caught, kpp)
        self.until_vs_steps(P, *caught["until"])
        self.receivers(P, cfg)
        self.knob_headlines(P, cfg)

    def route_vs_sort(self, P, st, accum, kw, kpp):
        """Route and sort compactions of one state: the alive slots bit for
        bit, the route's padding inert, per pixel flushed + retained
        radiance to f32 summation order; each engine event-timed."""
        k_new = kw["k_new"]
        na = int(st.path_alive.sum())

        def sort_c():
            return P._compact(st, accum.clone(), k_new=k_new,
                              lanes_per_pixel=kpp, tail_sorted=True)

        def route_c():
            return P._compact_route(st, accum.clone(), k_new=k_new,
                                    lanes_per_pixel=kpp)
        new_s, acc_s = sort_c()
        new_r, acc_r = route_c()
        lanes, err = exact_cmp(tuple(x[:, :na] for x in new_r),
                               tuple(x[:, :na] for x in new_s))
        inert = bool((new_r.s_quota[0, na:] == 0).all()
                     and (new_r.sample[0, na:] == 0).all()
                     and not new_r.path_alive[0, na:].any())

        def totals(new, acc):
            t = acc.double().clone()
            t.index_add_(1, (new.pixel[0] // kpp).long(), new.radiance_sum.double())
            return t
        ta, tb = totals(new_r, acc_r), totals(new_s, acc_s)
        rel = float(((ta - tb).abs() / tb.abs().clamp_min(1e-3)).max())
        ms_s, ms_r = cuda_ms(sort_c, 5), cuda_ms(route_c, 5)
        self.say("18 route", f"headline's first above-floor compaction, "
                 f"{st.pixel.shape[1]} -> {k_new} lanes ({na} alive): route vs "
                 f"sort alive slots {lanes} lanes differ, max |err| {err:.1e} "
                 f"(must be 0); padding inert {inert}; per-pixel accumulated + "
                 f"retained radiance max rel diff {rel:.2e} (<= 1e-5, f32 "
                 f"summation order); sort {ms_s:.3f} ms, route {ms_r:.3f} ms "
                 f"[{self.card}]")
        check(lanes == 0 and err == 0.0, "route and sort alive slots differ")
        check(inert, "the route's padding is not inert")
        check(rel <= 1e-5, f"route vs sort accumulator: {rel}")

    def flushes(self, P, caught, kpp):
        """The window flush and the run-sum flush against index_add_ on the
        headline's dropped tails (the first above-floor compaction's,
        pixel-ascending; the first split event's, argsorted; a sparse one
        that overflows the window), with TF32 matmuls allowed around the
        calls; and, to show the check would catch it, a TF32 contraction."""
        st, acc, kw = caught["above"]
        key = (~st.path_alive[0]).to(torch.int32) * P._SORT_PIX_LIM + st.pixel[0]
        tail = torch.sort(key, stable=True).indices[kw["k_new"]:]
        pix_s = st.pixel[0, tail] // kpp
        rad_s = st.radiance_sum[:, tail]
        st_b, acc_b, kw_b = caught["below"]
        tail_b = torch.sort((~st_b.path_alive[0]).to(torch.int32),
                            stable=True).indices[kw_b["k_new"]:]
        pix_b = st_b.pixel[0, tail_b] // kpp
        order = torch.sort(pix_b, stable=True).indices
        head = min(100_000, pix_s.shape[0] // 2)
        sparse = torch.cat([torch.arange(head, device=self.dev),
                            torch.arange(head, pix_s.shape[0], 600, device=self.dev)])
        tails = {"sorted": (acc, pix_s, rad_s),
                 "argsorted": (acc_b, pix_b[order], st_b.radiance_sum[:, tail_b][:, order]),
                 "sparse": (acc, pix_s[sparse], rad_s[:, sparse])}
        m = torch.backends.cuda.matmul
        m.allow_tf32 = True
        try:
            for label, (a0, pix, rad) in tails.items():
                check(bool((pix[1:] >= pix[:-1]).all()), f"{label} tail not ascending")
                want = a0.clone().index_add_(1, pix, rad)
                pad = (-pix.shape[0]) % P._FLUSH_BLOCK
                p2 = torch.cat([pix, pix[-1:].expand(pad)]).reshape(-1, P._FLUSH_BLOCK)
                over = int(((p2[:, -1] - p2[:, 0] // 128 * 128) >= P._FLUSH_WIN).sum())
                errs = {}
                for name, fn in (("window", lambda: P._window_flush(a0.clone(), pix, rad)),
                                 ("run-sum", lambda: P._flush(a0.clone(), pix, rad,
                                                              ascending=True))):
                    got = fn()
                    errs[name] = float(((got - want).abs()
                                        / want.abs().clamp_min(1e-3)).max())
                    errs[name + " ms"] = cuda_ms(fn, 3)
                plain_ms = cuda_ms(lambda: a0.clone().index_add_(1, pix, rad), 3)
                self.say("18 flush", f"{label} tail, {pix.shape[0]} lanes "
                         f"({over} of {p2.shape[0]} blocks overflow the window), "
                         f"TF32 allowed: max rel diff vs index_add_ window "
                         f"{errs['window']:.2e}, run-sum {errs['run-sum']:.2e} "
                         f"(<= 1e-5); window {errs['window ms']:.3f} ms, run-sum "
                         f"{errs['run-sum ms']:.3f} ms, index_add_ {plain_ms:.3f} ms "
                         f"[{self.card}]")
                check(errs["window"] <= 1e-5 and errs["run-sum"] <= 1e-5,
                      f"{label} tail flush: {errs}")
                check(over > 0 or label != "sparse",
                      "the sparse tail does not reach the run-sum path")
            # A TF32 contraction of the sorted tail's first block.
            b, w = P._FLUSH_BLOCK, P._FLUSH_WIN
            pix, rad = pix_s[:b], rad_s[:, :b]
            w0 = int(pix[0]) // 128 * 128
            onehot = ((pix - w0)[:, None] == torch.arange(w, device=self.dev)).float()
            tf32 = rad @ onehot
        finally:
            m.allow_tf32 = False
        exact = torch.zeros((3, w), device=self.dev).index_add_(1, pix - w0, rad)
        tf32_err = float(((tf32 - exact).abs() / exact.abs().clamp_min(1e-3)).max())
        self.say("18 flush", f"the same first block contracted with TF32 "
                 f"allowed and not pinned: max rel diff {tf32_err:.2e} (over the "
                 f"1e-5 bound: {tf32_err > 1e-5})")

    def until_vs_steps(self, P, args, kw):
        """p_render_until on the card from the staged headline's first
        stage state (its bounces on the batch loop's kernel tail) against
        successive p_bounce_step calls (the torch chain): the same exit
        step and count and a bit-equal state."""
        scene, cam, st0, salt, step0, target, dims, max_steps = args
        P.HOST_READS = 0
        st_u, step_u, cnt_u = P.p_render_until(*args, **kw)
        reads = P.HOST_READS
        step_kw = {k: v for k, v in kw.items() if k != "tail"}
        seq, step = st0, step0
        while True:
            step += 1
            seq = P.p_bounce_step(scene, cam, seq, salt, step, dims, **step_kw)
            cnt = int(seq.path_alive.sum())
            if cnt <= target or step >= max_steps:
                break
        lanes, err = exact_cmp(tuple(st_u), tuple(seq))
        self.say("18 until", f"staged headline's first stage: {st0.pixel.shape[1]} "
                 f"lanes from step {step0}, target {target}: p_render_until "
                 f"step {step_u}, count {cnt_u}, {reads} host reads; stepped "
                 f"step {step}, count {cnt}; {lanes} lanes differ, max |err| "
                 f"{err:.1e} (must be 0)")
        check((step_u, cnt_u) == (step, cnt), "p_render_until exit differs")
        check(lanes == 0 and err == 0.0, "p_render_until state differs")

    def receivers(self, P, cfg):
        """The headline with redistribute="on": at each receiver event the
        unstarted samples per pixel are unchanged, exactly."""
        from win32_raytracer_tpu_torch.api import render
        kpp = P._resolve_kpp(cfg, cfg.samples)
        real = P._compact
        events = []

        def remaining(st):
            rem = torch.clamp_min(st.s_quota - 1 - st.sample, 0)[0].long()
            out = torch.zeros(cfg.width * cfg.height, dtype=torch.long,
                              device=self.dev)
            return out.index_add_(0, (st.pixel[0] // kpp).long(), rem)

        def spy(st, accum, **k):
            new, acc = real(st, accum, **k)
            if k.get("n_receivers"):
                moved = int(new.s_quota[0, -k["n_receivers"]:].sum())
                events.append((st.pixel.shape[1], k["k_new"], k["n_receivers"],
                               moved, bool(torch.equal(remaining(st),
                                                       remaining(new)))))
            return new, acc
        P._compact = spy
        try:
            res = render("final", cfg=cfg.replace(redistribute="on"), device=self.dev)
        finally:
            P._compact = real
        self.say("18 receivers", f"headline, redistribute=on: {len(events)} "
                 "receiver events (lanes -> kept, receivers, samples moved, "
                 f"per-pixel unstarted samples equal): {events}; image mean "
                 f"{res.image.mean():.3f}")
        check(events, "no receiver event on the headline")
        check(all(e[-1] for e in events), "a receiver event lost samples")

    def knob_headlines(self, P, cfg):
        """Each knob's full headline: the u8 mean, the launches (kernel B,
        and kernel A or B-multi), the wall (median of 3 after a warm call),
        the host reads of a render and the event-timed span of its
        compactions."""
        from win32_raytracer_tpu_torch.api import render
        self.knob_walls = {}
        for label, knob in KNOBS:
            c = cfg.replace(**knob)
            render("final", cfg=c, device=self.dev)
            walls = []
            for _ in range(3):
                reset_launches()
                P.HOST_READS = 0
                torch.cuda.synchronize()
                res = render("final", cfg=c, device=self.dev)
                walls.append(res.duration_ms / 1e3)
                got, reads = launches(), P.HOST_READS
            spans = []
            real = {name: getattr(P, name) for name in ("_compact", "_compact_route")}

            def timed(fn):
                def wrapper(*a, **k):
                    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    s.record()
                    out = fn(*a, **k)
                    e.record()
                    spans.append((s, e))
                    return out
                return wrapper
            for name, fn in real.items():
                setattr(P, name, timed(fn))
            try:
                render("final", cfg=c, device=self.dev)
                torch.cuda.synchronize()
            finally:
                for name, fn in real.items():
                    setattr(P, name, fn)
            comp_ms = sum(s.elapsed_time(e) for s, e in spans)
            mean = float(res.image.mean())
            wall = float(np.median(walls))
            self.knob_walls[label] = wall
            self.say("18 " + label, f"final {c.width}x{c.height}@{c.samples}: "
                     f"wall median {wall:.4f} s of {[round(x, 4) for x in walls]} "
                     f"(default {self.knob_walls['default']:.4f} s), image mean "
                     f"{mean:.3f} (170.1 +- 1.5), {reads} host reads, "
                     f"{len(spans)} compactions spanning {comp_ms:.2f} ms on the "
                     f"stream, launches {got} [{self.card}]")
            check(abs(mean - HEADLINE_MEAN) <= HEADLINE_MEAN_TOL,
                  f"{label}: headline image mean {mean}")
            check(got["bounce"] > 0 and (got["hit"] > 0 or got["bounce_multi"] > 0),
                  f"{label}: launches {got}")
            check_route(got, ("bounce",), ("hit", "bounce_multi"), label)

    # ---- phase 19 ---------------------------------------------------------
    def checkpoints(self):
        """Checkpoints on the card: two uninterrupted headlines bit-equal in
        their linear f32 images (and the same with index_add_ as the flush,
        for comparison, with both flushes' walls); the headline at 4 passes
        stopped after 2 and resumed, byte-identical and its .npz
        accumulator bit-equal; the headline in 4 row chunks stopped after 2
        and resumed; the wavefront's final 1200x800@4 in 2 passes stopped
        after 1 and resumed; one CLI render with --checkpoint."""
        import win32_raytracer_tpu_torch.persistent as P
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.io.image import read_image
        from win32_raytracer_tpu_torch.scene.builders import get_scene
        from win32_raytracer_tpu_torch.utils import checkpoint as CK

        dev = self.dev
        cfg = RenderConfig(**HEADLINE)
        scene = get_scene("final", device=dev)

        def linear():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = P.render_image_persistent(scene, None, cfg)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        real = P._flush

        def index_add(accum, pix, rad, ascending=False):
            return accum.index_add_(1, pix, rad)
        linear()
        runs = {"run-sum": [], "index_add_": []}
        for flush in ("run-sum", "index_add_", "index_add_", "run-sum",
                      "run-sum", "index_add_"):
            P._flush = real if flush == "run-sum" else index_add
            try:
                runs[flush].append(linear())
            finally:
                P._flush = real
        diff = {k: [int((v[0][0] != x[0]).any(-1).sum()) for x in v[1:]]
                for k, v in runs.items()}
        walls = {k: [round(x[1], 4) for x in v] for k, v in runs.items()}
        self.say("19 determinism", f"headline linear f32 images, runs 2-3 vs run 1, "
                 f"pixels that differ: run-sum flush {diff['run-sum']} (must be 0), "
                 f"index_add_ flush {diff['index_add_']}; walls (interleaved) "
                 f"run-sum {walls['run-sum']} s (median "
                 f"{np.median(walls['run-sum']):.4f}), index_add_ "
                 f"{walls['index_add_']} s (median {np.median(walls['index_add_']):.4f}) "
                 f"[{self.card}]")
        check(diff["run-sum"] == [0, 0], "two headlines differ")
        del runs

        root = os.path.dirname(os.path.abspath(__file__))
        ck_dir = os.path.join(root, "out", "chip_smoke_ckpt")
        shutil.rmtree(ck_dir, ignore_errors=True)
        os.makedirs(ck_dir)

        def ck(name):
            return os.path.join(ck_dir, name)

        def run(c, path, sc=scene, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = CK.render_with_checkpoints(sc, None, c, path, device=dev, **kw)
            return img, time.perf_counter() - t0

        cases = (("pass level, persistent", cfg, 4, dict(max_passes_per_run=2), {}),
                 ("chunk level", cfg.replace(rays_per_chunk=HEADLINE_CHUNK_RAYS), 1,
                  dict(max_chunks_per_run=2), dict(chunk_checkpoints=True)),
                 ("pass level, wavefront", RenderConfig(**WAVEFRONT), 2,
                  dict(max_passes_per_run=1), {}))
        for label, c, passes, stop, resume in cases:
            tag = label.replace(" ", "_").replace(",", "")
            full, t_full = run(c, ck(tag + "_full.npz"), passes=passes)
            part, t_part = run(c, ck(tag + "_part.npz"), passes=passes, **stop)
            mid = CK.load_checkpoint(ck(tag + "_part.npz"))
            resumed, t_res = run(c, ck(tag + "_part.npz"), passes=passes, **resume)
            a = CK.load_checkpoint(ck(tag + "_full.npz"))
            b = CK.load_checkpoint(ck(tag + "_part.npz"))
            same_img = resumed is not None and np.array_equal(full, resumed)
            same_acc = bool(np.array_equal(a[0], b[0])) and a[1] == b[1] == passes
            self.say("19 " + label, f"{c.width}x{c.height}@{c.samples} in "
                     f"{passes} pass(es): uninterrupted {t_full:.3f} s; stopped "
                     f"({'pass' if mid[1] else 'chunk y0'} "
                     f"{mid[1] or mid[2]['chunk_y0']}) in {t_part:.3f} s and "
                     f"resumed in {t_res:.3f} s: u8 image identical {same_img}, "
                     f".npz accumulator bit-equal {same_acc}, mean "
                     f"{full.mean():.3f} [{self.card}]")
            check(part is None, f"{label}: the stopped run finished")
            check(same_img and same_acc, f"{label}: the resumed render differs")

        out = ck("cli.bmp")
        path = ck("cli.npz")
        cmd = [sys.executable, "-m", "win32_raytracer_tpu_torch.cli", "96", "64",
               "16", "--scene", "test", "--checkpoint", path, "--passes", "2",
               "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                              timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
        img = read_image(out)
        want, _ = run(RenderConfig(width=96, height=64, samples=16, stratify=False),
                      ck("cli_in_process.npz"), sc=get_scene("test"), passes=2)
        saved = CK.load_checkpoint(path)
        self.say("19 cli", f"{' '.join(cmd[3:6])} --checkpoint ... --passes 2 in "
                 f"{wall:.2f} s (process included): "
                 f"{' | '.join(proc.stderr.strip().splitlines())}; passes done "
                 f"{saved[1]}, BMP equal to the in-process checkpointed render: "
                 f"{bool(np.array_equal(img, want))}")
        check(saved[1] == 2, "CLI checkpoint passes")
        check(np.array_equal(img, want), "CLI checkpointed image differs")

    # ---- phase 20 ---------------------------------------------------------
    def tri_arms(self):
        """The triangle grid's other arms at config 4 (mesh20k, 800x450,
        50 spp): kernel D against its plain version, exact as phase 7 holds
        it, on bounce 2's rays sorted by capped chord keys and on the DDA
        pair sets at K = 4 and K = 12 (parked and t_cap = 0 pairs
        included), beside the unsorted and the binned sets, with its stats
        and ms on each; the whole passes against the direct pass; the cost
        of the sort + unsort and of the expansion + merge; then the renders
        under each arm (tri_arm_renders)."""
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import hit as K
        from win32_raytracer_tpu_torch.kernels import tri_grid as KD
        from win32_raytracer_tpu_torch.kernels.dispatch import (
            get_hit_fn_rows_accel)
        from win32_raytracer_tpu_torch.kernels.tri_dda import (
            dda_pairs, dda_tri_pass)
        from win32_raytracer_tpu_torch.kernels.tri_rebin import (
            capped_chord_keys, sorted_tri_pass)
        from win32_raytracer_tpu_torch.persistent import (
            _bin_sort_core, _derive_bin_box, p_bounce_step)
        from win32_raytracer_tpu_torch.scene.builders import get_scene
        from win32_raytracer_tpu_torch.tri_accel import (
            DEFAULT_TRI_GRID_RAY_BLOCK, clip_segment_to_box,
            hit_triangles_grid_rows_plain)

        dev = self.dev
        cfg = RenderConfig(**CONFIG4, backend="jnp")
        hit_scene, plain_fn = get_hit_fn_rows_accel(
            cfg, get_scene("mesh20k", device=dev))
        grid, spheres = hit_scene.triangles, hit_scene.spheres
        tris = tri_arrays(grid.base)
        min_t = cfg.min_hit_t
        st, dims, cam = fresh_chunk(cfg, dev)
        n = st.pixel.shape[1]
        st = p_bounce_step(hit_scene, cam, st, 12345, 1, dims, cfg=cfg,
                           hit_fn=plain_fn, lean=True)
        o2, d2, t2 = (x.contiguous() for x in (st.origin, st.direction, st.time))
        cap2 = K.hit_spheres_rows(spheres, o2, d2, t2).t.contiguous()
        binned = _bin_sort_core(st, box=_derive_bin_box(cfg, hit_scene))
        ob, db, tb_ = (x.contiguous() for x in (binned.origin, binned.direction,
                                                binned.time))
        capb = K.hit_spheres_rows(spheres, ob, db, tb_).t.contiguous()
        del st, binned
        zeros2 = torch.zeros((1, n), device=dev)
        perm = torch.sort(capped_chord_keys(grid.scene_box, o2, d2, cap2[0],
                                            min_t=min_t), stable=True).indices
        sets = [("unsorted", o2, d2, cap2), ("binned", ob, db, capb),
                ("sorted", o2[:, perm], d2[:, perm], cap2[:, perm])]
        for k in (4, 12):
            key, o_p, d_p, cap_p, _, _ = dda_pairs(grid.scene_box, o2, d2,
                                                   cap2[0], k_max=k,
                                                   min_t=min_t)
            pp = torch.sort(key, stable=True).indices
            sets.append((f"DDA K={k}", o_p[:, pp], d_p[:, pp], cap_p[:, pp]))
            del key, o_p, d_p, cap_p, pp
        rb = DEFAULT_TRI_GRID_RAY_BLOCK
        for label, o, d, cap in sets:
            m = o.shape[1]
            zeros = torch.zeros((1, m), device=dev)
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            rk = KD.hit_triangles_grid_rows(grid, o, d, zeros, t_cap=cap,
                                            stats=stats)
            t0 = time.perf_counter()
            rp = hit_triangles_grid_rows_plain(grid, o, d, zeros, t_cap=cap)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            c = compare_tri(rk, rp, o, d, tris, f"kernel D, {label}",
                            below_cap(rk, rp, cap))
            check(c["disagree"] == 0 and c["ties"] == 0 and c["err"] == 0.0,
                  f"kernel D {label}: not exact against plain ({fmt_cmp(c)})")
            tiles, pairs, touches, walked = (int(x) for x in stats.cpu())
            ms = cuda_ms(lambda: KD.hit_triangles_grid_rows(grid, o, d, zeros,
                                                            t_cap=cap), 5)
            ctas = -(-m // rb) * -(-rb // KD.SWEEP_LANES_PER_CTA)
            parked = int((cap[0] == 0).sum())
            # Phase 7's bound: both launches' operations, the function's
            # bytes (rays and caps in, record out, the grid's tables).
            bl = bound(pairs * OPS_TRI_PAIR + touches * OPS_ANY_TOUCH
                       + m * OPS_TRI_CLIP + -(-m // rb) * grid.n_tiles * OPS_TRI_TLO,
                       m * (24 + 4 + RECORD_BYTES) + grid.tile_attrs.numel() * 4
                       + grid.tile_boxes.numel() * 4)
            self.say("20 kernel D", f"{label}: {m} lanes ({parked} with "
                     f"t_cap 0), vs plain {fmt_cmp(c)}; {pairs} pair tests "
                     f"({pairs / n:.1f} per bounce lane), {touches} any-touch "
                     f"tests, per CTA ({ctas}) {walked / ctas:.2f} walk entries "
                     f"and {tiles / ctas:.2f} tiles staged; kernel D {ms:.4f} ms "
                     f"(bound {bl[0]:.4f} ms, {bl[1]}), the plain sweep "
                     f"{plain_s:.2f} s of wall [{self.card}]")
            check(pairs > 0, f"kernel D {label}: no pair test")
            del rk, rp, zeros
        del sets

        # The whole passes (kernel D inside) against the direct pass, and
        # their overheads: the same pass with the sweep replaced by its
        # precomputed record.
        def kd(g, o, d, t, min_t=min_t, t_cap=None):
            return KD.hit_triangles_grid_rows(g, o, d, t, min_t=min_t,
                                              t_cap=t_cap)
        direct = kd(grid, o2, d2, zeros2, t_cap=cap2)
        direct_ms = cuda_ms(lambda: kd(grid, o2, d2, zeros2, t_cap=cap2), 5)
        live_d = below_cap(direct, direct, cap2) & direct.hit[0].cpu().numpy()
        hi_chord = clip_segment_to_box(grid.scene_box, o2, d2, t_cap=cap2[0],
                                       min_t=min_t)[1]
        srt = sorted_tri_pass(kd, grid, o2, d2, zeros2, cap2, min_t=min_t)
        c = compare_tri(srt, direct, o2, d2, tris, "sorted pass vs direct",
                        below_cap(srt, direct, cap2))
        self.rebin_ties = c["ties"]
        check(c["disagree"] == 0 and c["err"] == 0.0,
              f"sorted pass vs direct: {fmt_cmp(c)}")
        inner = {}

        def stub(g, o, d, t, min_t=min_t, t_cap=None):
            return inner["rec"]
        inner["rec"] = kd(grid, o2[:, perm], d2[:, perm], zeros2[:, perm],
                          t_cap=cap2[:, perm])
        sort_ms = cuda_ms(lambda: sorted_tri_pass(stub, grid, o2, d2, zeros2,
                                                  cap2, min_t=min_t), 5)
        pass_ms = cuda_ms(lambda: sorted_tri_pass(kd, grid, o2, d2, zeros2,
                                                  cap2, min_t=min_t), 5)
        self.say("20 rebin pass", f"sorted_tri_pass vs the direct kernel D pass "
                 f"on bounce 2 ({n} lanes): {fmt_cmp(c)}; the pass "
                 f"{pass_ms:.4f} ms against the direct {direct_ms:.4f} ms; "
                 f"keys + sort + gathers + unsort {sort_ms:.4f} ms [{self.card}]")
        for k in (4, 12):
            dda = dda_tri_pass(kd, grid, o2, d2, zeros2, cap2, k_max=k,
                               min_t=min_t)
            live_x = below_cap(dda, dda, cap2) & dda.hit[0].cpu().numpy()
            both = live_d & live_x
            t_d, t_x = direct.t[0].cpu().numpy(), dda.t[0].cpu().numpy()
            i_d, i_x = direct.idx[0].cpu().numpy(), dda.idx[0].cpu().numpy()
            # A pair's window ends exactly at its interval's end, the last
            # one at the chord's end (scene box exit or t_cap): a hit there
            # (a triangle on the box's face) rounds in or out of the window
            # from the shifted origin, where the direct pass keeps it.
            # Those are counted apart; any other mask difference fails.
            end = hi_chord.cpu().numpy()
            t_any = np.where(live_d, t_d, t_x)
            at_end = np.abs(t_any - end) <= 1e-6 * np.maximum(1.0, np.abs(end))
            mask_diff = live_d != live_x
            end_diff = int((mask_diff & at_end).sum())
            real_diff = int((mask_diff & ~at_end).sum())
            idx_diff = int((both & (i_d != i_x)).sum())
            same = both & (i_d == i_x)
            dt = float(np.abs(t_x - t_d)[same].max(initial=0.0))
            # The reference's tolerance: rtol = atol = 2e-5.
            far_t = int((same & (np.abs(t_x - t_d)
                                 > 2e-5 * (1.0 + np.abs(t_d)))).sum())
            key_, o_p, d_p, cap_p, _, _ = dda_pairs(grid.scene_box, o2, d2,
                                                    cap2[0], k_max=k, min_t=min_t)
            pp = torch.sort(key_, stable=True).indices
            m = key_.numel()
            inner["rec"] = kd(grid, o_p[:, pp], d_p[:, pp],
                              torch.zeros((1, m), device=dev), t_cap=cap_p[:, pp])
            del key_, o_p, d_p, cap_p, pp
            over_ms = cuda_ms(lambda: dda_tri_pass(stub, grid, o2, d2, zeros2,
                                                   cap2, k_max=k, min_t=min_t), 3)
            pass_ms = cuda_ms(lambda: dda_tri_pass(kd, grid, o2, d2, zeros2,
                                                   cap2, k_max=k, min_t=min_t), 3)
            self.say("20 DDA pass", f"dda_tri_pass K={k} vs the direct pass: "
                     f"{int(live_d.sum())} surviving hits, surviving masks "
                     f"differ in {real_diff} lanes and at the chord's end in "
                     f"{end_diff} (direct only {int((live_d & ~live_x).sum())}, "
                     f"DDA only {int((live_x & ~live_d).sum())}), winners in "
                     f"{idx_diff}, max "
                     f"|dt| {dt:.3e} where the winner agrees; the pass "
                     f"{pass_ms:.4f} ms (expansion + sort + gathers + unsort + "
                     f"merge {over_ms:.4f} ms) against the direct "
                     f"{direct_ms:.4f} ms [{self.card}]")
            check(real_diff == 0 and idx_diff <= 1e-4 * n and far_t == 0,
                  f"DDA K={k} pass vs direct: masks {real_diff} (and {end_diff} "
                  f"at the chord's end), winners {idx_diff}, {far_t} t's "
                  "beyond 2e-5")
            del dda
        inner.clear()
        del direct, srt, o2, d2, t2, cap2, ob, db, tb_, capb, zeros2, perm, hi_chord
        torch.cuda.empty_cache()
        self.tri_arm_renders()

    def tri_arm_renders(self):
        """Config 4 under each arm through the entry point: one warm call,
        one counted call (launches set to 0 just before it and read just
        after, kernel D's stats summed), three timed calls interleaved
        across the arms (median); linear images: tri_rebin="on" against the
        unbinned render bit for bit (kernel D's cross-tile ties counted
        apart), "dda" (K = 4 and 12) within the reference's envelope,
        tri_sub_gate=2 bit-equal to the default; every arm's u8 mean within
        3.0 of the default's."""
        import win32_raytracer_tpu_torch.persistent as P
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import dispatch as D
        from win32_raytracer_tpu_torch.scene.builders import get_scene

        base = RenderConfig(**CONFIG4)
        arms = [(label, base.replace(**kw)) for label, kw in TRI_ARMS]
        path = ("hit", "tri_grid_sched", "tri_grid", "scatter")
        real_kd = D.hit_triangles_grid_rows
        stats = torch.zeros(4, dtype=torch.int64, device=self.dev)

        def with_stats(*a, **k):
            # The triangle pass hands kernel D its own stats (None unless a
            # render records): this one takes their place.
            k["stats"] = stats
            return real_kd(*a, **k)
        res = {}
        for label, c in arms:
            render("mesh20k", cfg=c, device=self.dev)
            stats.zero_()
            D.hit_triangles_grid_rows = with_stats
            try:
                reset_launches()
                torch.cuda.synchronize()
                r = render("mesh20k", cfg=c, device=self.dev)
                got = launches()
            finally:
                D.hit_triangles_grid_rows = real_kd
            check_route(got, path, (), f"config 4, {label}")
            res[label] = dict(mean=float(r.image.mean()), launches=got,
                              stats=[int(x) for x in stats.cpu()], walls=[])
        for _ in range(3):
            for label, c in arms:
                torch.cuda.synchronize()
                r = render("mesh20k", cfg=c, device=self.dev)
                res[label]["walls"].append(r.duration_ms / 1e3)
        scene = get_scene("mesh20k", device=self.dev)
        lin = {label: P.render_image_persistent(scene, None, c)
               for label, c in arms}
        torch.cuda.synchronize()
        mean0 = res["default"]["mean"]
        for label, _ in arms:
            r = res[label]
            tiles, pairs, touches, walked = r["stats"]
            self.say("20 " + label, f"mesh20k {base.width}x{base.height}@"
                     f"{base.samples}: wall median {np.median(r['walls']):.4f} s "
                     f"of {[round(x, 4) for x in r['walls']]}, image mean "
                     f"{r['mean']:.3f} (default {mean0:.3f}), kernel D {pairs} "
                     f"pair tests, {touches} any-touch tests, {walked} walk "
                     f"entries, {tiles} CTA tiles staged, launches "
                     f"{r['launches']} [{self.card}]")
            check(abs(r["mean"] - mean0) <= 3.0,
                  f"config 4 {label}: mean {r['mean']} against {mean0}")

        def differ(a, b):
            return int((lin[a] != lin[b]).any(-1).sum())
        rebin_px = differ("tri_rebin=on", "ray_binning=off")
        gate_px = differ("tri_sub_gate=2", "default")
        self.say("20 equality", f"linear images: tri_rebin=on vs ray_binning=off "
                 f"{rebin_px} pixels differ (kernel D ties between the sorted "
                 f"and unsorted bounce-2 sets: {self.rebin_ties}); tri_sub_gate=2 "
                 f"vs default {gate_px} pixels differ")
        check(gate_px == 0, "tri_sub_gate=2 render differs from the default")
        check(rebin_px == 0 or (self.rebin_ties > 0 and rebin_px
                                <= 1e-4 * base.width * base.height),
              f"tri_rebin=on render: {rebin_px} pixels differ, "
              f"{self.rebin_ties} ties")
        off = lin["ray_binning=off"].cpu().numpy()
        for label in ("tri_rebin=dda", "tri_rebin=dda, K=12"):
            x = lin[label].cpu().numpy()
            diff = np.abs(np.sqrt(np.clip(x, 0, 1)) - np.sqrt(np.clip(off, 0, 1)))
            far = float((diff > 8 / 255).mean())
            self.say("20 equality", f"{label} vs ray_binning=off: mean |diff| of "
                     f"the square-rooted images {diff.mean():.3e} (< 2e-3), share "
                     f"beyond 8/255 {far:.2e} (< 0.01)")
            check(diff.mean() < 2e-3 and far < 0.01,
                  f"{label}: outside the reference's envelope")

    def adaptive_headline(self):
        """The headline under adaptive_alloc="on" (and with adaptive_pool
        "on") against the default: alloc_lanes's invariants exact on each
        chunk's arrays, its arrays the same in two runs, two adaptive
        headlines bit-equal, the means within 170.1 +- 1.5, kernel B's and
        kernel A's launches, host reads and walls (median of 3 after a warm
        call, interleaved)."""
        import win32_raytracer_tpu_torch.persistent as P
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.scene.builders import get_scene

        base = RenderConfig(**HEADLINE)
        arms = [("default", base), ("adaptive", base.replace(adaptive_alloc="on")),
                ("adaptive + pool", base.replace(adaptive_alloc="on",
                                                 adaptive_pool="on"))]
        res = {}
        for label, c in arms:
            render("final", cfg=c, device=self.dev)
            reset_launches()
            P.HOST_READS = 0
            torch.cuda.synchronize()
            r = render("final", cfg=c, device=self.dev)
            got, reads = launches(), P.HOST_READS
            check_route(got, ("bounce", "bounce_multi"), (),
                        f"headline, {label}")
            res[label] = dict(mean=float(r.image.mean()), launches=got,
                              reads=reads, walls=[])
        for _ in range(3):
            for label, c in arms:
                torch.cuda.synchronize()
                r = render("final", cfg=c, device=self.dev)
                res[label]["walls"].append(r.duration_ms / 1e3)
        for label, _ in arms:
            r = res[label]
            self.say("20 " + label, f"final {base.width}x{base.height}@"
                     f"{base.samples}: wall median {np.median(r['walls']):.4f} s "
                     f"of {[round(x, 4) for x in r['walls']]}, image mean "
                     f"{r['mean']:.3f} (170.1 +- 1.5), {r['reads']} host reads, "
                     f"launches {r['launches']} [{self.card}]")
            check(abs(r["mean"] - HEADLINE_MEAN) <= HEADLINE_MEAN_TOL,
                  f"headline {label}: image mean {r['mean']}")

        # Two adaptive headlines, linear, with every chunk's allocation.
        scene = get_scene("final", device=self.dev)
        real = P.alloc_lanes
        for label, c in arms[1:]:
            runs = []
            for _ in range(2):
                allocs = []

                def spy(est, **k):
                    out = real(est, **k)
                    allocs.append((est.clone(), k, tuple(x.clone() for x in out)))
                    return out
                P.alloc_lanes = spy
                try:
                    img = P.render_image_persistent(scene, None, c)
                    torch.cuda.synchronize()
                finally:
                    P.alloc_lanes = real
                runs.append((img, allocs))
            (img_a, al_a), (img_b, al_b) = runs
            same_img = bool(torch.equal(img_a, img_b))
            same_est = len(al_a) == len(al_b) and all(
                torch.equal(a[0], b[0]) for a, b in zip(al_a, al_b))
            same_alloc = same_est and all(
                torch.equal(x, y) for a, b in zip(al_a, al_b)
                for x, y in zip(a[2], b[2]))
            for est, k, (pixel, s_base, s_quota) in al_a:
                alloc_invariants(pixel[0], s_base[0], s_quota[0],
                                 n_pix=est.numel(), **k)
            lanes = [int(a[2][0].shape[1]) for a in al_a]
            counts = torch.bincount(al_a[0][2][0][0], minlength=al_a[0][0].numel())
            self.say("20 " + label, f"{len(al_a)} chunk(s) of {lanes} lanes: "
                     f"alloc_lanes invariants exact; lanes a pixel min "
                     f"{int(counts.min())}, max {int(counts.max())}; prepass "
                     f"estimates equal in two runs {same_est}, arrays equal "
                     f"{same_alloc}; linear headlines bit-equal {same_img}")
            check(same_alloc, f"{label}: alloc_lanes arrays differ between runs")
            check(same_img, f"{label}: two headlines differ")


    # ---- phase 21 ---------------------------------------------------------
    def multi_device(self):
        """The sharded paths (parallel/) on this one card: D ranks as D
        processes sharing cuda:0, so the phase checks the lane partition,
        the lockstep decisions and the cross-rank reduce, and its walls
        measure the sharded loop's overhead, not scaling.  Any rank's failure
        fails the phase (spawn raises)."""
        from win32_raytracer_tpu_torch.parallel.dryrun import spawn

        self.say("21 nccl", nccl_probe())
        means = getattr(self, "fly_small_means", None)
        if means is None:
            means = fly_small_means(self.dev)
        spawn(MESH_D, p21_ranks, self.card, means, device_type="cuda")
        spawn(1, p21_single, self.card, device_type="cuda")


# Phase 21: D ranks on the one card; the small renders' scenes and sizes.
MESH_D = 2
MESH_SMALL = dict(width=160, height=120, samples=16, seed=2)
MESH_SMALL_SCENES = ("final", "test", "mesh")
MESH_FLOOR = 1 << 14   # the floor of the small renders (kernel B runs)
MESH_CKPT = dict(width=600, height=400, samples=32, seed=4)


def say21(mesh, what: str, msg: str) -> None:
    """Rank 0 prints a phase-21 line."""
    from win32_raytracer_tpu_torch.parallel.shard import mesh_rank
    if mesh_rank(mesh) == 0:
        print(f"[21 {what}] {msg}", flush=True)


def fly_small_means(dev) -> list:
    """Phase 12's small flythrough frame means (the batched kernel frames
    of FLY_SMALL on one card, the floor at 2^14)."""
    import win32_raytracer_tpu_torch.persistent as P
    from win32_raytracer_tpu_torch.animation import orbit_path, render_animation
    from win32_raytracer_tpu_torch.config import RenderConfig
    from win32_raytracer_tpu_torch.scene.builders import get_scene

    small = RenderConfig(**FLY_SMALL)
    cams = orbit_path(n_frames=8, aspect_ratio=small.width / small.height,
                      device=dev)
    saved = P._COMPACT_FLOOR
    P._COMPACT_FLOOR = 1 << 14
    try:
        fk = np.stack(render_animation(get_scene("final", device=dev), cams,
                                       small, device=dev))
    finally:
        P._COMPACT_FLOOR = saved
    return fk.reshape(8, -1).mean(1).tolist()


_NCCL_PROBE = """
import sys
sys.path.insert(0, {root!r})
import torch.distributed as dist
from win32_raytracer_tpu_torch.parallel.dryrun import spawn
def probe(mesh):
    import torch
    from win32_raytracer_tpu_torch.parallel.shard import all_gather
    return [int(x) for x in all_gather(torch.ones(1, device='cuda'), mesh)]
if __name__ == '__main__':
    print(spawn(2, probe, device_type='cuda', backend='nccl'))
"""


def nccl_probe(timeout: float = 120.0) -> str:
    """Two NCCL ranks on one card, in a process group of their own that
    is killed after ``timeout``: what NCCL does with them (the reason
    parallel/shard.pick_backend takes gloo when ranks share a card)."""
    import signal
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "probe.py")
        with open(script, "w") as f:
            f.write(_NCCL_PROBE.format(root=root))
        proc = subprocess.Popen([sys.executable, script], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            return f"2 NCCL ranks on one card: no answer in {timeout:.0f} s (killed)"
    lines = [ln for ln in out.splitlines() if ln.strip()]
    hits = [ln.strip() for ln in lines
            if re.search(r"[Dd]uplicate GPU|ncclInvalidUsage|NCCL error", ln)]
    what = hits[0] if hits else (lines[-1].strip() if lines else "no output")
    verdict = "refused" if proc.returncode else "accepted"
    return (f"2 NCCL ranks on one card: {verdict} (exit {proc.returncode}): "
            f"{what[:300]}")


def p21_launches(mesh, got: dict) -> str:
    """Each rank's launches ``got`` (a launches() dict), rank order."""
    from win32_raytracer_tpu_torch.parallel.shard import gather_ints
    names = list(_counters())
    got = gather_ints([got[k] for k in names], mesh)
    return "; ".join(f"rank {r}: " + str({k: int(v) for k, v in zip(names, row) if v})
                     for r, row in enumerate(got))


def p21_ranks(mesh, card: str, small_means: list) -> None:
    """Phase 21 on each of MESH_D ranks sharing the card (gloo)."""
    import torch.distributed as dist
    import win32_raytracer_tpu_torch.persistent as P
    from win32_raytracer_tpu_torch.animation import orbit_path, render_animation
    from win32_raytracer_tpu_torch.config import RenderConfig
    from win32_raytracer_tpu_torch.parallel.persistent_shard import (
        render_image_persistent_sharded)
    from win32_raytracer_tpu_torch.parallel.shard import (
        barrier, mesh_rank, rank_device, render_image_sharded)
    from win32_raytracer_tpu_torch.render import tonemap
    from win32_raytracer_tpu_torch.scene.builders import get_scene
    from win32_raytracer_tpu_torch.utils import checkpoint as CK

    dev = rank_device(mesh)
    d = mesh.size()
    say21(mesh, "mesh", f"{d} ranks on {torch.cuda.device_count()} card(s), "
          f"backend {dist.get_backend()}, rank 0 on {dev}")

    # Small renders: kernels bit-equal to plain, twice; each route's kernels
    # (with kernel B, the tail below the floor on B-multi and B: no kernel
    # A; the wavefront's rows and spp modes: the hit kernels and the draw
    # kernel); where kernel B runs, the default bit-equal to
    # multi_backend="xla" (the torch chain below the floor).
    routes = {("final", "persistent"): ("bounce",),
              ("test", "persistent"): ("bounce",),
              ("mesh", "persistent"): ("hit", "tri", "scatter"),
              ("mesh", "rows"): ("hit_cols", "tri_cols", "draws"),
              ("mesh", "spp"): ("hit_cols", "tri_cols", "draws")}
    saved = P._COMPACT_FLOOR
    P._COMPACT_FLOOR = MESH_FLOOR
    try:
        for name in MESH_SMALL_SCENES:
            scene = get_scene(name, device=dev)
            for mode in ("persistent", "rows", "spp"):
                cfg = RenderConfig(**MESH_SMALL)

                def run(c):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if mode == "persistent":
                        out = render_image_persistent_sharded(scene, None, c, mesh)
                    else:
                        out = render_image_sharded(scene, None, c, mesh, mode=mode)
                    torch.cuda.synchronize()
                    return out, time.perf_counter() - t0
                reset_launches()
                k1, t1 = run(cfg)
                got = launches()
                k2, _ = run(cfg)
                pl, tp = run(cfg.replace(backend="jnp"))
                same = bool(torch.equal(k1, pl)) and bool(torch.equal(k1, k2))
                ran = routes.get((name, mode), ("hit_cols", "draws"))
                check_route(got, ran, ("bounce_multi",) if "bounce" in ran else (),
                            f"{name} {mode} on {d} ranks")
                say21(mesh, "small", f"{name} {cfg.width}x{cfg.height}@{cfg.samples} "
                      f"{mode}: kernels bit-equal to plain and to a second run "
                      f"{same}, u8 mean {float(tonemap(k1).float().mean()):.3f}, "
                      f"{t1:.3f} s (plain {tp:.3f} s); launches "
                      f"{p21_launches(mesh, got)}")
                check(same, f"{name} {mode}: sharded kernel render differs "
                      "from plain or from its second run")
                if "bounce" not in ran:
                    continue
                reset_launches()
                kx, tx = run(cfg.replace(multi_backend="xla"))
                got_x = launches()
                same = bool(torch.equal(k1, kx))
                say21(mesh, "small xla", f"{name} {mode} under multi_backend="
                      f"\"xla\": bit-equal to the default {same}, {tx:.3f} s "
                      f"(default {t1:.3f} s); launches {p21_launches(mesh, got_x)}")
                check_route(got_x, ("bounce",), ("hit",),
                            f"{name} {mode} xla on {d} ranks")
                check(same, f"{name} {mode}: sharded default differs from "
                      "multi_backend='xla'")
    finally:
        P._COMPACT_FLOOR = saved

    # The headline over the ranks: mean, launches, median wall of 3; then
    # multi_backend "xla" and "fused" against the default, which each must
    # equal.
    cfg = RenderConfig(**HEADLINE)
    scene = get_scene("final", device=dev)

    def headline(c):
        barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_image_persistent_sharded(scene, None, c, mesh)
        img = tonemap(out).cpu().numpy()
        return out, img, time.perf_counter() - t0
    headline(cfg)
    walls, lin = [], None
    for _ in range(3):
        reset_launches()
        lin, img, wall = headline(cfg)
        walls.append(wall)
    got = launches()
    mean = float(img.mean())
    say21(mesh, "headline", f"final {cfg.width}x{cfg.height}@{cfg.samples} "
          f"spp over {d} ranks on one card: walls {[round(w, 4) for w in walls]} s (median "
          f"{np.median(walls):.4f}), image mean {mean:.3f} (170.1 +- 1.5), "
          f"launches {p21_launches(mesh, got)} [{card}]")
    check_route(got, ("bounce", "bounce_multi"), (), "sharded headline")
    check(abs(mean - HEADLINE_MEAN) <= HEADLINE_MEAN_TOL,
          f"sharded headline mean {mean}")
    headline(cfg.replace(multi_backend="xla"))
    reset_launches()
    xla, _, t_x = headline(cfg.replace(multi_backend="xla"))
    got = launches()
    same = bool(torch.equal(xla, lin))
    say21(mesh, "xla", f"the headline under multi_backend=\"xla\" (the torch "
          f"chain below the per-rank floor): {t_x:.4f} s (default median "
          f"{np.median(walls):.4f}), linear image bit-equal to the default's "
          f"{same} ({int((xla != lin).any(-1).sum())} pixels differ), launches "
          f"{p21_launches(mesh, got)} [{card}]")
    check_route(got, ("bounce", "hit"), (), "sharded multi_backend=xla")
    check(same, "sharded default differs from multi_backend='xla'")
    del xla
    reset_launches()
    fused, _, t_f = headline(cfg.replace(multi_backend="fused"))
    got = launches()
    same = bool(torch.equal(fused, lin))
    say21(mesh, "fused", f"the headline under multi_backend=\"fused\" (kernel "
          f"B's k-bounce above the per-rank floor): {t_f:.4f} s, linear image "
          f"bit-equal to the default's {same} "
          f"({int((fused != lin).any(-1).sum())} pixels differ), launches "
          f"{p21_launches(mesh, got)} [{card}]")
    check_route(got, ("bounce", "bounce_multi"), (),
                "sharded multi_backend=fused")
    check(same, "sharded multi_backend='fused' differs from the default")
    del lin, fused

    # BASELINE config 5 over the ranks (bench/configs.py:84-110: the
    # flythrough sharded in row blocks): one batch of 8 frames.
    cfg5 = RenderConfig(**CONFIG5)
    cams = orbit_path(n_frames=8, aspect_ratio=cfg5.width / cfg5.height,
                      device=dev)
    render_animation(scene, cams, cfg5.replace(seed=cfg5.seed + 7001),
                     mesh=mesh, shard_mode="rows")
    reset_launches()
    barrier(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = render_animation(scene, cams, cfg5, mesh=mesh, shard_mode="rows")
    wall = time.perf_counter() - t0
    got = launches()
    fmeans = [float(f.mean()) for f in frames]
    rays = cfg5.width * cfg5.height * cfg5.samples * len(cams)
    say21(mesh, "config 5", f"final, 8 frames {cfg5.width}x{cfg5.height}@"
          f"{cfg5.samples} spp over {d} ranks "
          f"(shard_mode=\"rows\"): {wall:.4f} s, {len(frames) / wall:.3f} fps, "
          f"{rays / wall / 1e6:.3f} Mrays/s, frame means "
          f"{[round(x, 2) for x in fmeans]} (within {FLY_MEAN_TOL} of phase "
          f"12's small frames {[round(x, 2) for x in small_means]}), "
          f"launches {p21_launches(mesh, got)} [{card}]")
    check(len(frames) == 8 and all(f.shape == (cfg5.height, cfg5.width, 3)
                                   for f in frames), "sharded config 5 shapes")
    check_route(got, ("bounce", "bounce_multi"), (), "sharded config 5")
    check(all(abs(x - y) <= FLY_MEAN_TOL for x, y in zip(fmeans, small_means)),
          f"sharded config 5 frame means {fmeans}")

    # A pass-level checkpoint over the ranks, stopped and resumed.
    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out",
                          "chip_smoke_ckpt", "mesh")
    if mesh_rank(mesh) == 0:
        shutil.rmtree(ck_dir, ignore_errors=True)
        os.makedirs(ck_dir)
    barrier(mesh)
    c = RenderConfig(**MESH_CKPT)

    def ck(name, **kw):
        t0 = time.perf_counter()
        img = CK.render_with_checkpoints(scene, None, c, os.path.join(ck_dir, name),
                                         passes=4, mesh=mesh, **kw)
        return img, time.perf_counter() - t0
    full, t_full = ck("full.npz")
    part, t_part = ck("part.npz", max_passes_per_run=2)
    resumed, t_res = ck("part.npz")
    a = CK.load_checkpoint(os.path.join(ck_dir, "full.npz"))
    b = CK.load_checkpoint(os.path.join(ck_dir, "part.npz"))
    same = resumed is not None and bool(np.array_equal(full, resumed))
    same_acc = bool(np.array_equal(a[0], b[0])) and a[1] == b[1] == 4
    say21(mesh, "checkpoint", f"final {c.width}x{c.height}@{c.samples} in 4 "
          f"passes over {d} ranks: uninterrupted {t_full:.3f} s; stopped after "
          f"2 passes in {t_part:.3f} s and resumed in {t_res:.3f} s: u8 image "
          f"identical {same}, .npz accumulator bit-equal {same_acc} [{card}]")
    check(part is None and same and same_acc, "sharded checkpoint resume differs")


def p21_single(mesh, card: str) -> None:
    """The headline over one rank under NCCL: mean, wall, and the pixels
    that differ from the one-card headline (other floor and min_lanes, so
    no equality is asked)."""
    import torch.distributed as dist
    from win32_raytracer_tpu_torch.api import render
    from win32_raytracer_tpu_torch.config import RenderConfig

    cfg = RenderConfig(**HEADLINE)
    render("final", cfg=cfg, mesh=mesh, shard_mode="persistent")
    walls = []
    for _ in range(3):
        reset_launches()
        res = render("final", cfg=cfg, mesh=mesh, shard_mode="persistent")
        walls.append(res.duration_ms / 1e3)
    got = launches()
    one = render("final", cfg=cfg, device=res.device)
    mean = float(res.image.mean())
    differ = int((res.image != one.image).any(-1).sum())
    say21(mesh, "D=1", f"the headline over 1 rank (backend "
          f"{dist.get_backend()}): walls {[round(w, 4) for w in walls]} s "
          f"(median {np.median(walls):.4f}; one card, no mesh: "
          f"{one.duration_ms / 1e3:.4f}), mean {mean:.3f}, pixels that differ "
          f"from the one-card headline {differ} of {one.image.shape[0] * one.image.shape[1]}, "
          f"launches {p21_launches(mesh, got)} [{card}]")
    check(abs(mean - HEADLINE_MEAN) <= HEADLINE_MEAN_TOL,
          f"D=1 sharded headline mean {mean}")
    check_route(got, ("bounce", "bounce_multi"), (), "D=1 sharded headline")


# Phase 11's routes: (label, knob, kernels the route must launch, kernels
# it may launch besides, the kernel whose main path it is).  Where kernel B
# runs, the tail below the floor is kernels B-multi and B, no kernel A,
# unless multi_backend="xla"; where it does not, every bounce is the split
# bounce with kernel F, unless scatter_backend="pallas" keeps the torch
# tail below the floor, which may launch kernel A.
ROUTES = (
    ("default", {}, ("bounce", "bounce_multi"), (), "bounce_multi"),
    ("fuse_bounce=off", dict(fuse_bounce="off"), ("hit_sky", "scatter"), (),
     "hit_sky"),
    ("scatter_backend=pallas", dict(scatter_backend="pallas"),
     ("hit_sky", "scatter"), ("hit",), None),
    ("hit_kernel=v4", dict(hit_kernel="v4"), ("hit", "scatter"), (), None),
    ("multi_backend=xla", dict(multi_backend="xla"), ("bounce",), ("hit",),
     None),
    ("multi_backend=fused", dict(multi_backend="fused"),
     ("bounce", "bounce_multi"), (), None),
)
ROUTE_SMALL = dict(width=160, height=120, samples=16, seed=2)
# Phase 18's knobs of the persistent scheduler, each on the headline.
KNOBS = (("default", {}),
         ("compactor=route", dict(compactor="route")),
         ("flush_mode=window", dict(flush_mode="window")),
         ("one_shot=on", dict(one_shot="on")),
         ("one_shot=staged", dict(one_shot="staged")),
         ("redistribute=on", dict(redistribute="on")))
# Phase 20's arms of config 4: the triangle grid's working-set sort and DDA
# expansion beside the binned default and the unbinned render.
TRI_ARMS = (("default", {}),
            ("ray_binning=off", dict(ray_binning="off")),
            ("tri_rebin=on", dict(tri_rebin="on")),
            ("tri_rebin=dda", dict(tri_rebin="dda")),
            ("tri_rebin=dda, K=12", dict(tri_rebin="dda", tri_dda_k=12)),
            ("tri_sub_gate=2", dict(tri_sub_gate=2)))
# Kernel I's launches on the sphere grid: schedule kernel, then the sweep;
# kernel F after it (the split bounce's scatter + respawn).
GRID_ROUTE = ("hit_grid_sched", "hit_grid")
GRID_SPLIT = GRID_ROUTE + ("scatter",)
# Phase 11's scenes with no kernel B (name, scene, settings) and sizes: a
# small one and each cell's (port_bench/configs), on one shared seed.
SPLIT_SCENES = (("final accel=grid", "final", dict(accel="grid")),
                ("mesh", "mesh", {}),
                ("mesh20k", "mesh20k", {}))
SPLIT_SMALL = dict(width=160, height=120, samples=16)
SPLIT_CELL = {"final": dict(width=1200, height=800, samples=100),
              "mesh": dict(width=800, height=450, samples=50),
              "mesh20k": dict(width=800, height=450, samples=50)}
SPLIT_SEED = 3054198966
CONFIG5 = dict(width=640, height=480, samples=32, seed=3)   # bench/configs.py:85-110
# The small flythrough: config 5's views at 96x72, 8 spp.  Batched against
# unbatched frames draw other seeds, so only their statistics agree.
FLY_SMALL = dict(width=96, height=72, samples=8, seed=3)
FLY_SMALL_MAX_DIFF = 12.0
FLY_SMALL_MIN_R = 0.9
# Config 5's frame means against the small frames of the same views.
FLY_MEAN_TOL = 6.0


# Kernel A's launch forms, each held exactly to the plain sweep: the
# default (rays per thread by batch size), one and two rays per thread.
HIT_FORMS = (("default", {}),
             ("R=1", dict(_rays=1)),
             ("R=2", dict(_rays=2)))

# The kernels whose registers and sweep loops phase 1 prints: the packed
# sweeps' (A, B, B-multi, E, G; C, H) and the grids' (D, I).
SWEEP_KERNELS = ("hit_kernel", "bounce_kernel", "bounce_multi_kernel",
                 "hit_sky_kernel", "hit_cols_kernel", "tri_kernel",
                 "tri_cols_kernel", "tri_grid_kernel",
                 "hit_grid_kernel", "tri_grid_schedule_kernel",
                 "hit_grid_schedule_kernel")

# The draw kernel, whose registers and instruction mix phase 1 prints.
DRAW_KERNEL = "threefry_uniform_kernel"

KERNEL_META = {
    "hit": ("sphere_hit", "win32_raytracer_tpu_torch/csrc/hit.cu",
            "win32_raytracer_tpu/kernels/hit_pallas_v6.py:181"),
    "bounce": ("fused_bounce", "win32_raytracer_tpu_torch/csrc/bounce.cu",
               "win32_raytracer_tpu/kernels/bounce_pallas.py:38"),
    "tri": ("triangle_hit", "win32_raytracer_tpu_torch/csrc/tri.cu",
            "win32_raytracer_tpu/kernels/tri_pallas_mxu.py:114"),
    "tri_grid": ("triangle_grid_hit", "win32_raytracer_tpu_torch/csrc/tri_grid.cu",
                 "win32_raytracer_tpu/kernels/tri_grid_rows.py:252"),
    "bounce_multi": ("fused_bounce_multi", "win32_raytracer_tpu_torch/csrc/bounce.cu",
                     "win32_raytracer_tpu/kernels/bounce_pallas.py:186"),
    "hit_sky": ("hit_sky", "win32_raytracer_tpu_torch/csrc/hit_sky.cu",
                "win32_raytracer_tpu/kernels/hit_pallas_v7.py:106"),
    "scatter": ("scatter_respawn", "win32_raytracer_tpu_torch/csrc/scatter.cu",
                "win32_raytracer_tpu/kernels/scatter_pallas.py:383"),
    "hit_cols": ("sphere_hit_cols", "win32_raytracer_tpu_torch/csrc/hit_cols.cu",
                 "win32_raytracer_tpu/kernels/hit_pallas_v3.py:40"),
    "tri_cols": ("triangle_hit_cols", "win32_raytracer_tpu_torch/csrc/tri_cols.cu",
                 "win32_raytracer_tpu/kernels/tri_pallas.py:35"),
    "hit_grid": ("sphere_grid_hit", "win32_raytracer_tpu_torch/csrc/hit_grid.cu",
                 "win32_raytracer_tpu/kernels/hit_grid_rows.py:98"),
    # The schedule kernels take the XLA prelude of the same TPU kernels.
    "tri_grid_sched": ("triangle_grid_schedule",
                       "win32_raytracer_tpu_torch/csrc/tri_grid.cu",
                       "win32_raytracer_tpu/kernels/tri_grid_rows.py:252"),
    "hit_grid_sched": ("sphere_grid_schedule",
                       "win32_raytracer_tpu_torch/csrc/hit_grid.cu",
                       "win32_raytracer_tpu/kernels/hit_grid_rows.py:98"),
    # Replaces no TPU kernel: the JAX package's draws are XLA's.
    "draws": ("threefry_uniform", "win32_raytracer_tpu_torch/csrc/draws.cu",
              "none: jax.random.uniform (XLA)"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,18,19,20,21",
                    help="comma-separated phases to run (0 always runs)")
    ap.add_argument("--root", default=None,
                    help="import win32_raytracer_tpu_torch from this checkout "
                         "(phase 17 times another commit's kernels A, B, C, "
                         "D, E, G, H and I)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    # ---- phase 0 ----
    if not torch.cuda.is_available():
        print("[0 device] torch.cuda.is_available() is False: this needs a "
              "CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    import win32_raytracer_tpu_torch  # (fails outside the repo)
    print(f"[0 device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}; package "
          f"{os.path.dirname(win32_raytracer_tpu_torch.__file__)}", flush=True)
    print(f"[0 clocks] SM clock now, its maximum: "
          f"{card_line('clocks.sm,clocks.max.sm')}", flush=True)

    smoke = Smoke(card)
    if phases - {0}:
        smoke.build()
    if phases & {2, 3, 5, 9, 10}:
        smoke.kernel_a()
    if 3 in phases:
        smoke.kernel_b()
    if 4 in phases:
        smoke.small_render()
    if 5 in phases:
        smoke.headline()
        smoke.kernel_main_shapes()
    if 6 in phases:
        smoke.kernel_c()
    if 7 in phases:
        smoke.kernel_d()
    if 8 in phases:
        smoke.mesh_renders()
    if 9 in phases:
        smoke.split_kernels()
    if 10 in phases:
        smoke.kernel_b_multi()
    if 11 in phases:
        smoke.routes()
        smoke.split_scatter()
    if 12 in phases:
        smoke.flythrough()
    if 13 in phases:
        smoke.wavefront_kernels()
    if 14 in phases:
        smoke.wavefront_path()
    if 15 in phases:
        smoke.kernel_i()
    if 16 in phases:
        smoke.grid_path()
    if 17 in phases:
        smoke.ab_times()
    if 18 in phases:
        smoke.knobs()
    if 19 in phases:
        smoke.checkpoints()
    if 20 in phases:
        smoke.tri_arms()
        smoke.adaptive_headline()
    if 21 in phases:
        smoke.multi_device()
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, **{f: smoke.kernels[key][f] for f in keys},
                "library_ms": None}
               for key, (name, src, replaces) in KERNEL_META.items()
               if all(f in smoke.kernels.get(key, {}) for f in keys)]
    if kernels:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
