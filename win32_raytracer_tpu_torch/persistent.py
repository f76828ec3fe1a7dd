"""Persistent scheduler with batch compaction, lane-major (PyTorch port).

The port of ``win32_raytracer_tpu.persistent`` for sphere, triangle and
composite scenes.  Each lane owns one pixel replica
and runs its quota of samples one after another, respawning a camera
sample the moment a path ends; the host loop checks the alive count now
and then, compacts dead
lanes out while the batch is above ``_COMPACT_FLOOR`` (a stable sort on
the (dead, pixel) key onto the mantissa size grid, the dropped tail's
radiance added into ``accum``), and below it splits unstarted samples onto
clone lanes.

This module holds the steps, the compactors and flushes, the route
resolution, the render prelude (:func:`_prepare`) and the batch loop
(:class:`_Loop`) of both entry points: the single-card one here, by rows
(:func:`render_image_persistent`), and the sharded one over a mesh of
ranks (parallel/persistent_shard.py), which passes its floor and lockstep
in as data.

The reference's opt-in knobs: ``compactor="route"`` (a stable partition
by the alive bit, :func:`_route_partition`), ``flush_mode="window"``
(:func:`_window_flush`), ``redistribute="on"`` (receiver lanes at
above-floor compactions, :func:`_receive`), and ``one_shot`` "on" (the
tail below the floor finished by :func:`p_render_oneshot`) and "staged"
(:func:`p_render_until` stages between compact + split events).  Every
flush adds in an order fixed by its stream (:func:`_flush`), so a render
repeats bit for bit on a card and a checkpointed one resumes exactly.

Bounces (:func:`resolve_routes`): on a plain sphere scene, above the
floor one call of the fused bounce kernel (kernels/bounce.py); at or below
it k bounces per launch of the fused kernel (B-multi) and kernel B for
the rest, the same bounces as the torch chain's (:func:`p_bounce_step`:
the sphere kernel of kernels/hit.py followed by the torch scatter and
respawn here), which ``multi_backend="xla"`` runs there instead, as the
reference runs its XLA steps there.  ``fuse_bounce="off"``, an explicit
``scatter_backend`` or pixel ids of 2^24 and up split the bounce above
the floor: the hit + sky kernel (kernels/hit_sky.py), then the scatter +
respawn.  ``hit_kernel`` "v4" and "v6" have neither fused nor hit + sky
kernel: the sphere kernel plus the scatter at every size.  Kernel B sweeps
spheres only, so a scene with triangles, the sphere grid (``accel="grid"``)
and an explicit ``hit_fn`` take the two-step bounce at every size, as the
reference does: the hit function of kernels/dispatch.py (sphere kernel,
then kernel C or kernel D capped by the sphere hit, merged; or the sphere
grid's kernels A and I), then scatter and respawn (``p_hit_step``, then
kernel F or ``p_scatter_respawn_step``).  The scatter + respawn of such a
split bounce is kernel F (kernels/scatter.py) at every size on the
kernels backend, the same bounce as the torch scatter's, bit for bit;
``scatter_backend="pallas"`` takes it above the floor only, as the
reference does, and "jnp" keeps the torch scatter.

Multi-frame batches: a list of cameras renders its frames as one tall
virtual image, each lane taking the camera of its row's frame.

Difficulty-adaptive allocation (``adaptive_alloc="on"``, adaptive.py): each
chunk first runs ``max_depth + 1`` bounces of quota-1 lanes, kpp a pixel,
with no count read; the final depths give each pixel's path length; the
remaining samples then run on lanes allocated in proportion to it (raw
pixel ids, ``_Phase``), through the same check / compact / split loop.

Ray binning: when the triangle side is the Morton-tile grid (and on the
sphere grid under ``ray_binning="on"`` only), every bounce first sorts
the whole state by a chord key (origin cell, chord-exit cell, direction
octant; ``_bin_sort_core``), so each ray block of kernel D's
schedule is a tight spatial wedge; dead lanes sort last with their rays
parked outside every tile.  Binned renders take single steps (a multi-step
would run on bins gone stale after one scatter) and never run a chunk as
one shot.  Draws key on (salt, step, lane position) exactly as in the
reference, so the same schedule draws the same numbers.  Under
``tri_rebin`` "on" or "dda" the triangle pass sorts its own working set
after the sphere pass (kernels/tri_rebin.py, tri_dda.py) and the state is
not binned.

State is [3, N] / [1, N] rows, as in the reference.  ``accum`` is updated
in place, which saves a copy of the image per flush.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .accel import GridScene
from .adaptive import alloc_lanes
from .config import RenderConfig
from .core.rng import hash_uniform01
from .ops.hit import SphereTable
from .ops.rows import HitRecordRows, camera_rays_rows, scatter_rows, sky_color_rows
from .scene.camera import Camera, default_camera
from .scene.composite import CompositeScene
from .scene.spheres import SphereScene
from .scene.triangles import TriangleScene
from .tri_accel import TriGridScene
from .utils import profiling
from .utils.profiling import count, span

# Any scene the renderer takes, and what a hit function reads
# (kernels/dispatch.get_hit_fn_rows_accel).
Scene = Union[SphereScene, TriangleScene, CompositeScene]


class PathState(NamedTuple):
    origin: torch.Tensor        # [3, N] f32
    direction: torch.Tensor     # [3, N] f32
    time: torch.Tensor          # [1, N] f32
    throughput: torch.Tensor    # [3, N] f32
    radiance_sum: torch.Tensor  # [3, N] f32 — completed samples since last flush
    depth: torch.Tensor         # [1, N] i32 — recursion level of the next hit
    sample: torch.Tensor        # [1, N] i32 — lane-local sample index (-1 = none)
    pixel: torch.Tensor         # [1, N] i32 — pixel-lane id (y*W + x)*K + replica
    path_alive: torch.Tensor    # [1, N] bool
    s_base: torch.Tensor        # [1, N] i32 — lane's first global sample index
    s_quota: torch.Tensor       # [1, N] i32 — samples owned by this lane


class Dims(NamedTuple):
    """Render dimensions every step reads (the reference's ``dims`` row,
    as plain ints).  Stratify off is the (1, 1) grid and Russian roulette
    off is ``rr_start > max_depth``; both are identities."""

    width: int
    height: int
    kpp: int
    kx: int
    ky: int
    max_depth: int
    rr_start: int


def _stratify_grid(spp: int) -> tuple:
    """(kx, ky) with kx*ky == spp and kx the largest divisor <= sqrt(spp)."""
    kx = 1
    for cand in range(1, int(np.sqrt(spp)) + 1):
        if spp % cand == 0:
            kx = cand
    return kx, spp // kx


def make_dims(cfg: RenderConfig, width: int, height: int, spp: int,
              lanes_per_pixel: int = 1) -> Dims:
    kx, ky = _stratify_grid(spp) if cfg.stratify and spp > 1 else (1, 1)
    rr_start = (cfg.rr_start_depth if cfg.russian_roulette
                else cfg.max_depth + 2)
    return Dims(width, height, lanes_per_pixel, kx, ky, cfg.max_depth,
                rr_start)


def _hit_core(scene, st: PathState, *, cfg: RenderConfig, hit_fn):
    """Hit + sky: ``hit_fn(scene, ...)``; a miss adds the sky and ends the
    path."""
    rec: HitRecordRows = hit_fn(scene, st.origin, st.direction, st.time,
                                min_t=cfg.min_hit_t)
    miss = st.path_alive & ~rec.hit
    rad = st.radiance_sum + torch.where(
        miss, st.throughput * sky_color_rows(st.direction), 0.0)
    return rec, st._replace(radiance_sum=rad,
                            path_alive=st.path_alive & rec.hit)


# A render's bounce counters (``profiling.device_counters`` slots): the
# lanes whose path is alive when their bounce starts, and the paths the
# roulette ends.  Kernels B and B-multi add into the buffer on the card
# (``kernels/bounce.py``), the torch chain from its masks (:func:`_tally`);
# the batch loop makes one buffer a render while it records, for renders
# with kernel B that stratify or play the roulette (:class:`_Loop`).
BOUNCE_STATS = {0: "persistent.live_lanes", 1: "persistent.rr_kills"}


def _tally(stats: Optional[torch.Tensor], slot: int, mask) -> None:
    """Add the lanes ``mask`` sets to ``stats[slot]`` on the device (no
    host read); nothing without a buffer."""
    if stats is not None:
        stats.narrow(0, slot, 1).add_(mask.sum())


def _scatter_core(st: PathState, rec: HitRecordRows, salt, step_i,
                  dims: Dims, *, cfg: RenderConfig,
                  lean: bool = False, stats=None) -> PathState:
    n = st.origin.shape[1]
    draws = hash_uniform01((5, n), salt, step_i, 0x5CA77E12,
                           device=st.origin.device)
    sc = scatter_rows(st.direction, rec, draws, cfg)

    live = st.path_alive  # already restricted to hits by _hit_core
    thr = torch.where(live, st.throughput * sc.attenuation, st.throughput)
    o = torch.where(live, sc.origin, st.origin)
    d = torch.where(live, sc.direction, st.direction)
    depth = torch.where(live, st.depth + 1, st.depth)
    alive = live & sc.alive & (depth <= dims.max_depth)

    # Russian roulette; ``lean`` drops the block where it is an identity.
    if not lean:
        p = torch.clamp(thr.amax(dim=0, keepdim=True), 0.05, 1.0)
        rr_on = alive & (depth >= dims.rr_start)
        survive = draws[4:5] < p
        thr = torch.where(rr_on, thr / p, thr)
        alive = alive & torch.where(rr_on, survive, True)
        if stats is not None:
            _tally(stats, 1, rr_on & ~survive)

    return st._replace(origin=o, direction=d, throughput=thr, depth=depth,
                       path_alive=alive)


def _div(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x / d``, rounded as a true division.  On a card torch turns
    division by a Python scalar into multiplication by its reciprocal,
    which differs in the last place from the reference and the kernels;
    a 0-dim tensor divisor keeps the true division."""
    return x / x.new_full((), float(d))


def camera_frames(cam: Camera) -> int:
    """Frames of a camera: 1, or F of a frame-stacked one."""
    return cam.origin.shape[0] if cam.origin.dim() == 2 else 1


def _frame_cameras(cam: Camera, fid: torch.Tensor) -> Camera:
    """Each lane's camera of a frame-stacked ``cam``: [3, N] vectors and
    [1, N] scalars, contiguous (the rays made from them are state rows the
    kernels read).  A frame id outside [1, F) takes frame 0, as the
    reference's select chain does."""
    f = camera_frames(cam)
    sel = torch.where((fid >= 1) & (fid < f), fid, 0)[0].long()
    return Camera(*(x.T[:, sel].contiguous() if x.dim() == 2 else x[sel][None]
                    for x in cam))


def _respawn_core(cam: Camera, st: PathState, salt, step_i, dims: Dims, *,
                  cfg: RenderConfig, lean: bool = False) -> PathState:
    """Start the next camera sample on every lane whose path just ended.
    Pixel-lane id -> (x, y) by true integer division.

    ``cam`` may be frame-stacked ([F, 3] vectors, [F] scalars;
    ``kernels/bounce.unpack_camera`` of ``pack_cameras``): the batch then
    renders F frames at once, pixel-lane ids span a virtual image of
    F * height rows, and each lane takes the camera of frame
    row // height."""
    del cfg
    n = st.pixel.shape[1]
    pd = st.pixel // dims.kpp
    y, x = pd // dims.width, pd % dims.width
    if camera_frames(cam) > 1:
        fid = y // dims.height
        y = y - fid * dims.height
        cam = _frame_cameras(cam, fid)

    start = ~st.path_alive & (st.sample < st.s_quota - 1)
    new_sample = torch.where(start, st.sample + 1, st.sample)

    draws = hash_uniform01((5, n), salt, step_i, 0x2E59A301,
                           device=st.pixel.device)
    u_j, v_j = draws[0:1], draws[1:2]
    # Stratified jitter on the (kx, ky) grid; ``lean`` drops it where the
    # grid is (1, 1).
    if not lean:
        gs = st.s_base + new_sample  # global sample index
        sx, sy = gs % dims.kx, (gs // dims.kx) % dims.ky
        u_j = _div(sx.to(torch.float32) + u_j, dims.kx)
        v_j = _div(sy.to(torch.float32) + v_j, dims.ky)
    # Pixel mapping as RayTracer.cpp:941-943 (u=(x+r0)/W, v=(H-y+r1)/H).
    u = _div(x.to(torch.float32) + u_j, dims.width)
    v = _div((dims.height - y).to(torch.float32) + v_j, dims.height)
    o, d, tm = camera_rays_rows(cam, u, v, draws[2:5])

    return st._replace(
        origin=torch.where(start, o, st.origin),
        direction=torch.where(start, d, st.direction),
        time=torch.where(start, tm, st.time),
        throughput=torch.where(start, 1.0, st.throughput),
        depth=torch.where(start, 0, st.depth),
        sample=new_sample,
        path_alive=st.path_alive | start,
    )


p_respawn_step = _respawn_core
p_hit_step = _hit_core


def p_scatter_respawn_step(cam: Camera, st: PathState, rec: HitRecordRows,
                           salt, step_i, dims: Dims, *, cfg: RenderConfig,
                           lean: bool = False, stats=None) -> PathState:
    """Scatter + respawn after a hit step; ``stats`` gains the roulette's
    kills (:data:`BOUNCE_STATS`)."""
    st = _scatter_core(st, rec, salt, step_i, dims, cfg=cfg, lean=lean,
                       stats=stats)
    return _respawn_core(cam, st, salt, step_i, dims, cfg=cfg, lean=lean)


def p_bounce_step(scene, cam: Camera, st: PathState, salt, step_i,
                  dims: Dims, *, cfg: RenderConfig, hit_fn,
                  lean: bool = False, stats=None) -> PathState:
    """Hit + scatter + respawn, one bounce; ``scene`` is what ``hit_fn``
    reads.  ``stats`` gains kernel B's counts (:data:`BOUNCE_STATS`)."""
    _tally(stats, 0, st.path_alive)
    rec, st = p_hit_step(scene, st, cfg=cfg, hit_fn=hit_fn)
    return p_scatter_respawn_step(cam, st, rec, salt, step_i, dims, cfg=cfg,
                                  lean=lean, stats=stats)


# Bounces per below-floor multi-step (cfg.multi_k = 0).
_MULTI_K = 4


def p_bounce_multi_step(scene, cam: Camera, st: PathState, salt, step0,
                        dims: Dims, *, cfg: RenderConfig, hit_fn,
                        k: int = _MULTI_K, lean: bool = False,
                        stats=None) -> PathState:
    """``k`` bounces at steps step0..step0+k-1."""
    for i in range(k):
        st = p_bounce_step(scene, cam, st, salt, step0 + i, dims, cfg=cfg,
                           hit_fn=hit_fn, lean=lean, stats=stats)
    return st


def count_tail(steps: int, width: int, scatter: str = "torch") -> None:
    """Count ``steps`` bounces of ``width`` lanes at or below the floor off
    kernel B, and what ran their scatter + respawn: "torch" (the torch
    chain) or "kernel" (kernel F)."""
    count("persistent.steps_tail", steps)
    count("persistent.lanes_tail", steps * width)
    count("persistent.scatter_" + scatter, steps)


# p_render_oneshot reads the alive flag back once per this many bounces.
_ONESHOT_SYNC = 8


def p_render_oneshot(scene, cam: Camera, st: PathState, salt,
                     step0: int, dims: Dims, max_steps: int, *,
                     cfg: RenderConfig, hit_fn, lean: bool = False,
                     tail=None, stats=None) -> PathState:
    """A whole lane chunk to completion: bounces step0+1.. until every lane
    is dead or ``max_steps``.  After a bounce a dead lane has spent its
    quota (the bounce's respawn would have revived it otherwise), so the
    bounces after the last lane dies change nothing; the alive flag is
    read only every ``_ONESHOT_SYNC`` bounces.  As the tail finisher
    (one_shot="on") it takes over a chunk at ``step0`` from the host loop.

    ``tail(st, salt, step0, k, dims)``, where given, runs and counts each
    group of bounces on the kernels (the batch loop's kernels B-multi and
    B, or the split bounce on kernel F); without it the bounces are
    :func:`p_bounce_step` calls, which add into ``stats``."""
    step = step0
    while step < max_steps:
        n = min(_ONESHOT_SYNC, max_steps - step)
        if tail is not None:
            st = tail(st, salt, step + 1, n, dims)
            step += n
        else:
            for _ in range(n):
                step += 1
                st = p_bounce_step(scene, cam, st, salt, step, dims, cfg=cfg,
                                   hit_fn=hit_fn, lean=lean, stats=stats)
        if _alive_count(st.path_alive)() == 0:
            break
    if tail is None:
        count_tail(step - step0, st.pixel.shape[1])
    return st


# p_render_until queues this many bounces ahead of the alive count it
# waits for (the bounces past its exit are thrown away).
_UNTIL_AHEAD = 2


def p_render_until(scene, cam: Camera, st: PathState, salt, step0: int,
                   alive_target: int, dims: Dims, max_steps: int, *,
                   cfg: RenderConfig, hit_fn, lean: bool = False, tail=None,
                   stats=None):
    """One stage of the staged tail (one_shot="staged"): bounces step0+1..
    until the alive count after a bounce is <= ``alive_target``, or
    ``max_steps``; returns (state, step, alive count) at that bounce.

    A do-while: the first bounce always runs (a just-split batch's clones
    sit dead until the respawn inside it).  The state, step and count are
    those of successive :func:`p_bounce_step` calls stopped at the first
    bounce whose count reaches the target; each count is read behind the
    next bounce (``_UNTIL_AHEAD``), which is thrown away when the stage
    ends before it.  One host read per bounce.  ``tail`` runs the bounces
    on the kernels, as in :func:`p_render_oneshot`."""
    queue = []
    step = step0
    while True:
        while len(queue) < _UNTIL_AHEAD and (step < max_steps or not queue
                                             and step == step0):
            step += 1
            if tail is not None:
                st = tail(st, salt, step, 1, dims)
            else:
                st = p_bounce_step(scene, cam, st, salt, step, dims, cfg=cfg,
                                   hit_fn=hit_fn, lean=lean, stats=stats)
                count_tail(1, st.pixel.shape[1])
            queue.append((st, step, _alive_count(st.path_alive)))
        st_k, step_k, read = queue.pop(0)
        cnt = read()
        if cnt <= alive_target or step_k >= max_steps:
            return st_k, step_k, cnt


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


# Multi-frame batches pick the smallest lanes-per-pixel whose lane count
# reaches this (longer per-lane quotas shorten the batch's tail).
_KPP_LANE_TARGET = 1 << 21


def _resolve_kpp(cfg: RenderConfig, spp: int, n_frames: int = 1,
                 frame_pixels: int = 0) -> int:
    """cfg.lanes_per_pixel, or the auto choice.  One frame: the largest of
    8/4/2 that divides spp with a quota >= 4.  A multi-frame batch
    (n_frames > 1, frame_pixels = W*H): the smallest of 1/2/4/8 that
    divides spp and brings the batch's lanes to _KPP_LANE_TARGET, else the
    single-frame rule."""
    kpp = cfg.lanes_per_pixel
    if kpp <= 0:
        if n_frames > 1 and frame_pixels > 0:
            for cand in (1, 2, 4, 8):
                if spp % cand == 0 and (frame_pixels * n_frames * cand
                                        >= _KPP_LANE_TARGET):
                    return cand
        for cand in (8, 4, 2):
            if spp % cand == 0 and spp // cand >= 4:
                return cand
        return 1
    if spp % kpp:
        raise ValueError(f"lanes_per_pixel ({kpp}) must divide samples "
                         f"({spp})")
    return kpp


# Compaction size grid: 16 sizes per power-of-two octave above the floor,
# powers of two below it (the reference's constants).
_GRID_STEPS_LOG2 = 4
_COMPACT_SHRINK = 0.90       # compact when the grid size <= this x batch
_COMPACT_FLOOR = 1 << 19     # at/below: never compact above-floor style
# The smallest batch one card compacts to (a rank's: persistent_shard.py).
_MIN_LANES = 1 << 12
# The dead bit rides at this weight in the int32 (dead, pixel) sort key.
_SORT_PIX_LIM = 1 << 30


def _mantissa_grid(n: int, steps_log2: int = _GRID_STEPS_LOG2) -> int:
    """Round ``n`` up onto 2**steps_log2 sizes per power-of-two octave."""
    if n <= 0:
        return 0
    scale = 1 << max((n - 1).bit_length() - 1 - steps_log2, 0)
    return ((n + scale - 1) // scale) * scale


def _grid_size(n_alive: int, min_lanes: int, quantum: int = 0) -> int:
    if n_alive >= _COMPACT_FLOOR:
        if quantum:
            return ((n_alive + quantum - 1) // quantum) * quantum
        return max(min_lanes, _mantissa_grid(n_alive))
    return max(min_lanes, _next_pow2(n_alive))


# ---------------------------------------------------------------------------
# Flushes.  A dropped lane's radiance is added into ``accum`` in an order
# fixed by the stream alone, so a render repeats bit for bit on a card:
# ``index_add_`` on a CUDA float tensor adds colliding ids by atomics in no
# fixed order.  Each flush sorts its stream by pixel (stable), sums each
# pixel's run in a fixed tree of f32 adds and hands ``index_add_`` one
# nonzero addend per pixel (adding +0.0 changes nothing, in any order).

def _run_sums(pix: torch.Tensor, rad: torch.Tensor) -> torch.Tensor:
    """[3, T]: each run of equal ids in the ascending ``pix`` [T] summed
    (a segmented doubling scan, the same adds on every device) at the run's
    last entry, +0.0 elsewhere."""
    t = pix.shape[0]
    x = rad.clone()
    s = 1
    while s < t:
        # The right side is a new tensor: every step reads the last one's x.
        x[:, s:] += torch.where(pix[s:] == pix[:-s], x[:, :-s], 0.0)
        s *= 2
    last = torch.ones_like(pix, dtype=torch.bool)
    last[:-1] = pix[1:] != pix[:-1]
    return torch.where(last, x, 0.0)


def _flush(accum: torch.Tensor, pix: torch.Tensor, rad: torch.Tensor, *,
           ascending: bool = False) -> torch.Tensor:
    """``accum`` [3, P] += the per-pixel sums of ``rad`` [3, T] at pixel ids
    ``pix`` [T] (in place); ``ascending`` promises sorted ids."""
    if pix.shape[0] == 0:
        return accum
    if not ascending:
        order = torch.sort(pix, stable=True).indices
        pix, rad = pix[order], rad[:, order]
    return accum.index_add_(1, pix, _run_sums(pix, rad))


# Window flush (flush_mode="window", the reference's _window_flush): an
# ascending stream in blocks of _FLUSH_BLOCK entries, each block's sums a
# one-hot contraction onto its window of _FLUSH_WIN pixels from a 128-aligned
# base; blocks whose span overflows the window take the run-sum flush.  The
# contraction runs over _FLUSH_GROUP blocks at a time (a [32, 1024, 1152] f32
# one-hot is 151 MB; a whole tail's would be gigabytes).
_FLUSH_BLOCK = 1024
_FLUSH_WIN = 1024 + 128
_FLUSH_GROUP = 32


def _ieee_matmul(fn):
    """``fn()`` with TF32 matmuls off (the process's setting restored after):
    TF32 keeps 10 bits of the radiance's mantissa.  Through
    ``fp32_precision`` where torch has it: reading the older
    ``allow_tf32`` raises once a process has set the newer flag."""
    m = torch.backends.cuda.matmul
    name, off = (("fp32_precision", "ieee") if hasattr(m, "fp32_precision")
                 else ("allow_tf32", False))
    saved = getattr(m, name)
    setattr(m, name, off)
    try:
        return fn()
    finally:
        setattr(m, name, saved)


def _window_flush(accum: torch.Tensor, pix: torch.Tensor,
                  rad: torch.Tensor) -> torch.Tensor:
    """``accum`` [3, P] += the per-pixel sums of ``rad`` [3, T] at ASCENDING
    pixel ids ``pix`` [T] (all < P), in place.  The same sums as
    :func:`_flush` up to f32 summation order.

    A block's sums reach ``accum`` through its window, pixels strictly
    inside the block's span (no other block has them) by one ``index_add_``
    of every window; the first and last pixel of each span, which a run
    crossing blocks shares, go as a stream of two entries a block through
    :func:`_flush`, so that every pixel still gets one nonzero addend."""
    global HOST_READS
    t, p = pix.shape[0], accum.shape[1]
    if t == 0:
        return accum
    b, w = _FLUSH_BLOCK, _FLUSH_WIN
    pad = (-t) % b
    if pad:
        # The last id repeated (still ascending), zero radiance.
        pix = torch.cat([pix, pix[t - 1:].expand(pad)])
        rad = torch.nn.functional.pad(rad, (0, pad))
    nb = (t + pad) // b
    pix2 = pix.reshape(nb, b)
    rad2 = rad.reshape(3, nb, b).transpose(0, 1)        # [nb, 3, b]
    w0 = pix2[:, 0] // 128 * 128
    ok = (pix2[:, -1] - w0) < w
    off = pix2 - w0[:, None]
    iota = torch.arange(w, dtype=pix.dtype, device=pix.device)
    win = torch.empty((nb, 3, w), dtype=rad.dtype, device=rad.device)

    def contract():
        for g in range(0, nb, _FLUSH_GROUP):
            sl = slice(g, g + _FLUSH_GROUP)
            onehot = ((off[sl, :, None] == iota)
                      & ok[sl, None, None]).to(rad.dtype)   # [g, b, w]
            win[sl] = torch.bmm(rad2[sl], onehot)
    _ieee_matmul(contract)

    rows = torch.arange(nb, device=pix.device)
    first, last = pix2[:, 0], pix2[:, -1]
    fo = (first - w0).clamp_max(w - 1)
    lo = (last - w0).clamp_max(w - 1)
    head, tail = win[rows, :, fo], win[rows, :, lo]     # [nb, 3]
    head = torch.where((first == last)[:, None], 0.0, head)
    win[rows, :, fo] = 0.0
    win[rows, :, lo] = 0.0
    # Window positions past P hold zeros (every id is < P): clamp them.
    ids = (w0[:, None] + iota).clamp_max(p - 1).reshape(-1)
    accum.index_add_(1, ids, win.transpose(0, 1).reshape(3, nb * w))
    _flush(accum, torch.stack([first, last], 1).reshape(-1),
           torch.stack([head, tail], 2).transpose(0, 1).reshape(3, 2 * nb),
           ascending=True)
    # Overflowing blocks (sparse regions of the stream): their entries
    # through the run-sum flush (a host read, as the reference's lax.cond).
    bad = (~ok).nonzero()[:, 0]
    HOST_READS += 1
    if bad.numel():
        _flush(accum, pix2[bad].reshape(-1),
               rad2[bad].transpose(0, 1).reshape(3, -1), ascending=True)
    return accum


def _receive(new: PathState, accum: torch.Tensor, n_receivers: int,
             lanes_per_pixel: int, ascending: bool):
    """Receiver redistribution (redistribute="on"): the last
    ``n_receivers`` lanes of the compacted batch, which the caller keeps
    dead (n_receivers <= k_new - alive count), flush their radiance and
    adopt half the unstarted samples of as many donor lanes strided evenly
    over the rest.  Per pixel the sum of quotas is unchanged: a donor keeps
    s_quota - give, its receiver gets give at s_base + the kept quota."""
    k_new = new.pixel.shape[1]
    r0 = k_new - n_receivers
    stride = max(1, r0 // n_receivers)
    _flush(accum, new.pixel[0, r0:] // lanes_per_pixel,
           new.radiance_sum[:, r0:], ascending=ascending)
    give = torch.clamp_min(new.s_quota - 1 - new.sample, 0) // 2
    pos = torch.arange(k_new, device=new.pixel.device)
    donor = ((pos % stride == 0) & (pos // stride < n_receivers))[None]
    kept = torch.where(donor, new.s_quota - give, new.s_quota)

    def don(row):
        return row[:, ::stride][:, :n_receivers]

    def put(row, val):
        row = row.clone()
        row[:, r0:] = val
        return row

    return new._replace(
        s_quota=put(kept, don(give)),
        s_base=put(new.s_base, don(new.s_base) + don(kept)),
        pixel=put(new.pixel, don(new.pixel)),
        sample=put(new.sample, -1),
        depth=put(new.depth, 0),
        throughput=put(new.throughput, 1.0),
        radiance_sum=put(new.radiance_sum, 0.0),
        path_alive=put(new.path_alive, False),
    ), accum


def _compact(st: PathState, accum: torch.Tensor, *, k_new: int,
             lanes_per_pixel: int = 1, tail_sorted: bool = False,
             n_receivers: int = 0, flush: str = "scatter"):
    """The sort compactor: keep the live lanes (alive first, stable) in a
    [k_new] batch and add the dropped lanes' radiance into ``accum`` (in
    place) by :func:`_flush`, or by :func:`_window_flush` under ``flush``
    "window".

    ``tail_sorted`` promises ascending pixel ids; the key is then the
    composite (dead, pixel), which keeps the compacted head ascending too,
    and the dropped tail needs no sort.  Dropped lanes are all dead
    (k_new >= alive count): their radiance is final.  ``n_receivers`` > 0
    redistributes work onto the head's last lanes (:func:`_receive`)."""
    key = (~st.path_alive[0]).to(torch.int32)
    if tail_sorted:
        key = key * _SORT_PIX_LIM + st.pixel[0]
    perm = torch.sort(key, stable=True).indices
    head, tail = perm[:k_new], perm[k_new:]
    new = PathState(*(x[:, head] for x in st))
    if n_receivers > 0:
        new, accum = _receive(new, accum, n_receivers, lanes_per_pixel,
                              ascending=tail_sorted)
    drop_pix = st.pixel[0, tail] // lanes_per_pixel
    drop_rad = st.radiance_sum[:, tail]
    if flush == "window":
        if not tail_sorted:
            order = torch.sort(drop_pix, stable=True).indices
            drop_pix, drop_rad = drop_pix[order], drop_rad[:, order]
        return new, _window_flush(accum, drop_pix, drop_rad)
    return new, _flush(accum, drop_pix, drop_rad, ascending=tail_sorted)


# The route compactor (compactor="route", the reference's
# _compact_route_core): a stable partition by the alive bit with no sort.
# A cumsum of the bit gives each lane its slot (alive lanes left, dead
# lanes right, each in order) and one index_copy_ per field stack moves
# the columns: 13 f32 rows and 5 int32 rows, each in its own dtype (carried
# as f32 bits, small integers are denormals that a card may flush to zero).
# Alive lanes land in the slots the sort compactor gives them, so the
# render continues with the same draws.  The retained dead lanes become
# inert zero-quota padding that keeps pixel and radiance for the flush;
# the dropped tail (one ascending run per earlier compaction) is flushed
# through a sort.
_ROUTE_F32 = ("origin", "direction", "time", "throughput", "radiance_sum")
_ROUTE_I32 = ("depth", "sample", "pixel", "s_base", "s_quota")


def _route_partition(st: PathState, k_new: int):
    """The route compactor's partition: (the [k_new] head, the dropped
    lanes' pixel-lane ids [n - k_new], their radiance [3, n - k_new])."""
    alive = st.path_alive[0]
    a = alive.to(torch.int64)
    ca = torch.cumsum(a, 0)
    n_alive = ca[-1:]
    dest = torch.where(alive, ca - 1, n_alive + torch.cumsum(1 - a, 0) - 1)
    mat_f = torch.cat([getattr(st, f) for f in _ROUTE_F32])   # [13, n]
    mat_i = torch.cat([getattr(st, f) for f in _ROUTE_I32])   # [5, n]
    mat_f = torch.empty_like(mat_f).index_copy_(1, dest, mat_f)
    mat_i = torch.empty_like(mat_i).index_copy_(1, dest, mat_i)
    ha = (torch.arange(k_new, device=alive.device) < n_alive)[None]
    f, i = mat_f[:, :k_new], mat_i[:, :k_new]
    dir_pad = torch.zeros_like(f[3:6])
    dir_pad[2] = 1.0
    # Every field contiguous, as the kernels take them.
    new = PathState(
        origin=torch.where(ha, f[0:3], 0.0),
        direction=torch.where(ha, f[3:6], dir_pad),
        time=torch.where(ha, f[6:7], 0.0),
        throughput=torch.where(ha, f[7:10], 1.0),
        radiance_sum=f[10:13].contiguous(),
        depth=torch.where(ha, i[0:1], 0),
        sample=torch.where(ha, i[1:2], 0),
        pixel=i[2:3].contiguous(),
        path_alive=ha,
        s_base=torch.where(ha, i[3:4], 0),
        s_quota=torch.where(ha, i[4:5], 0),
    )
    return new, mat_i[2, k_new:], mat_f[10:13, k_new:]


def _compact_route(st: PathState, accum: torch.Tensor, *, k_new: int,
                   lanes_per_pixel: int = 1):
    """The route compactor (no receivers: those events keep the sort
    engine): keep the live lanes in a [k_new] batch, flush the rest by
    :func:`_flush` under any ``flush_mode``, as the reference does."""
    new, drop_pix, drop_rad = _route_partition(st, k_new)
    return new, _flush(accum, drop_pix // lanes_per_pixel, drop_rad)


# Receiver redistribution (redistribute="on"): above the floor, overshoot
# the compacted size by this factor and hand the spare dead lanes donor
# work, when at least _RECV_MIN lanes are spare.
_RECV_OVERSHOOT = 1.25
_RECV_MIN = 1 << 16


def _split(st: PathState) -> PathState:
    """Hand half of every lane's unstarted samples to a clone lane (sum of
    quotas per pixel unchanged).  Clones start dead with an empty path and
    respawn on the next step."""
    give = torch.clamp_min(st.s_quota - 1 - st.sample, 0) // 2
    keep_quota = st.s_quota - give
    clone = st._replace(
        throughput=torch.ones_like(st.throughput),
        radiance_sum=torch.zeros_like(st.radiance_sum),
        depth=torch.zeros_like(st.depth),
        sample=torch.full_like(st.sample, -1),
        path_alive=torch.zeros_like(st.path_alive),
        s_base=st.s_base + keep_quota,
        s_quota=give,
    )
    orig = st._replace(s_quota=keep_quota)
    return PathState(*(torch.cat([a, b], dim=1) for a, b in zip(orig, clone)))


# Ray binning (the reference's _bin_sort_core): sort the state before every
# bounce (_BIN_PERIOD) by (origin cell, chord-exit cell, direction octant),
# cells on a 4^3 grid over the triangle grid's scene box: 9 + 9 + 3 key
# bits.  Dead lanes key last (1 << 20) with parked rays.
_BIN_PERIOD = 1
_BIN_CELLS = 4
_BIN_DEAD_KEY = 1 << 20
_PARK_O = (0.0, -1e9, 0.0)
_PARK_D = (0.0, 0.0, 1.0)


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """3-bit value -> bits at positions 0, 3, 6."""
    return (v & 1) | ((v & 2) << 2) | ((v & 4) << 4)


def _bin_sort_core(st: PathState, *, box) -> PathState:
    """One stable sort of the whole state by chord bucket.

    ``box`` = (lo_x, lo_y, lo_z, inv_ext_x, inv_ext_y, inv_ext_z) of the
    grid's scene box (_derive_bin_box).  The key is computed in f32 as the
    reference computes it: the float64 products ``box[3 + ax] * n_c`` and
    hi sides ``lo + 1 / inv_ext`` are rounded to f32 once, cells truncate
    toward zero and clamp to [0, n_c).  Lane order changes which draws a
    sample sees, so binned images match unbinned ones statistically, as a
    different compaction cadence does."""
    alive = st.path_alive
    o, d = st.origin, st.direction
    n_c = _BIN_CELLS

    def morton(p):
        code = torch.zeros_like(p[0], dtype=torch.int32)
        for ax in range(3):
            c = (p[ax] - float(np.float32(box[ax]))) * float(
                np.float32(box[3 + ax] * n_c))
            # Clamp before the cast so out-of-range values saturate alike
            # on every device (the clip after it is the reference's).
            c = torch.clamp(c, -1.0, float(n_c)).to(torch.int32)
            code = code | (_spread3(torch.clamp(c, 0, n_c - 1)) << ax)
        return code

    eps = float(np.float32(1e-12))
    hi_t = torch.full_like(o[0], float(np.float32(1e8)))
    for ax in range(3):
        dn = torch.where(d[ax].abs() < eps,
                         torch.where(d[ax] < 0, -eps, eps), d[ax])
        lo_p = float(np.float32(box[ax]))
        hi_p = float(np.float32(box[ax] + 1.0 / box[3 + ax]))
        ta = (lo_p - o[ax]) / dn
        tb = (hi_p - o[ax]) / dn
        hi_t = torch.minimum(hi_t, torch.maximum(ta, tb))
    hi_t = torch.clamp_min(hi_t, 0.0)
    exit_p = [o[ax] + hi_t * d[ax] for ax in range(3)]
    octant = ((d[0] < 0).to(torch.int32) | ((d[1] < 0).to(torch.int32) << 1)
              | ((d[2] < 0).to(torch.int32) << 2))
    key_val = (morton(o) << 9) | (morton(exit_p) << 3) | octant
    key = torch.where(alive[0], key_val, _BIN_DEAD_KEY)

    park_o = o.new_tensor(_PARK_O)[:, None]
    park_d = d.new_tensor(_PARK_D)[:, None]
    st = st._replace(origin=torch.where(alive, o, park_o),
                     direction=torch.where(alive, d, park_d))
    perm = torch.sort(key, stable=True).indices
    return PathState(*(x[:, perm] for x in st))


def _tri_rebin_active(cfg: RenderConfig, scene) -> bool:
    """Whether the triangle pass sorts its own working set (``tri_rebin``
    "on" or "dda", kernels/tri_rebin.py and tri_dda.py): the hit scene's
    triangle side is a TriGridScene.  The one-shot conflict reads this, not
    the bin box, which is None under the rebin."""
    g = scene if isinstance(scene, TriGridScene) else getattr(
        scene, "triangles", None)
    return isinstance(g, TriGridScene) and cfg.tri_rebin in ("on", "dda")


def _derive_bin_box(cfg: RenderConfig, scene):
    """The ray-binning box of a hit scene: on ("auto" or "on") whenever the
    triangle side is a TriGridScene, unless the triangle pass sorts its own
    working set (:func:`_tri_rebin_active`: a state sort on top of it would
    be redundant); on the sphere grid's (x, z) tiles and y slab under "on"
    only ("auto" keeps its lane order, as the reference's does); None when
    binning is off or inapplicable."""
    if cfg.ray_binning == "off" or _tri_rebin_active(cfg, scene):
        return None
    g = scene if isinstance(scene, TriGridScene) else getattr(
        scene, "triangles", None)
    if isinstance(g, TriGridScene):
        sb = g.scene_box.cpu().numpy().astype(np.float64)
        lo3 = sb[0::2]
        ext = np.maximum(sb[1::2] - sb[0::2], 1e-6)
    elif isinstance(scene, GridScene) and cfg.ray_binning == "on":
        tb = scene.tile_boxes.cpu().numpy().astype(np.float64)
        ys = scene.y_slab.cpu().numpy().astype(np.float64)
        lo3 = np.array([tb[:, 0].min(), ys[0], tb[:, 2].min()])
        hi3 = np.array([tb[:, 1].max(), ys[1], tb[:, 3].max()])
        ext = np.maximum(hi3 - lo3, 1e-6)
    elif cfg.ray_binning == "on":
        raise ValueError(
            "ray_binning='on' needs a grid-accelerated scene "
            f"(got {type(scene).__name__})")
    else:
        return None
    return (float(lo3[0]), float(lo3[1]), float(lo3[2]),
            float(1.0 / ext[0]), float(1.0 / ext[1]), float(1.0 / ext[2]))


# The scheduler's reads of device values on the host (alive counts, the
# window flush's overflow test) since a caller last set this to 0.
HOST_READS = 0


def _alive_count(alive: torch.Tensor):
    """Start reading the alive count; returns a callable that waits for it
    (one host read).  On a card the count is copied back behind an event,
    so the caller can queue more bounces before it waits."""
    cnt = alive.sum()
    if cnt.device.type == "cuda":
        host = cnt.to("cpu", non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
    else:
        host, ready = cnt, None

    def read():
        global HOST_READS
        HOST_READS += 1
        if ready is not None:
            ready.synchronize()
        return int(host)
    return read


# Config values the port runs, and why it runs no other.
_SUPPORTED = {
    "pallas_interpret": ((False,), "'Not to port' (no interpret mode; "
                         "the plain versions run on the CPU)"),
}

# The values of the bounce-route and scheduler knobs (RenderConfig's
# comments); anything else raises ValueError.
_ROUTE_KNOBS = {
    "scatter_backend": ("auto", "pallas", "jnp"),
    "fuse_bounce": ("auto", "on", "off"),
    "multi_backend": ("", "xla", "fused"),
    "one_shot": ("auto", "on", "off", "staged"),
    "compactor": ("", "sort", "route"),
    "flush_mode": ("", "scatter", "window"),
    "redistribute": ("auto", "on", "off"),
}


def check_supported(cfg: RenderConfig, scene=None) -> None:
    """Raise NotImplementedError for a knob value this port does not run
    (after the reference's ValueError checks of the triangle knobs), and
    ValueError for an unknown value of a bounce-route or scheduler knob.
    (Whether ``accel="grid"`` applies to a scene is kernels/dispatch.py's
    check.)"""
    del scene
    from .kernels.dispatch import validate_tri_knobs
    validate_tri_knobs(cfg)
    for field, ok in _ROUTE_KNOBS.items():
        if getattr(cfg, field) not in ok:
            raise ValueError(f"unknown {field} {getattr(cfg, field)!r} "
                             f"(use {'|'.join(v or repr(v) for v in ok)})")
    for field, (ok, item) in _SUPPORTED.items():
        val = getattr(cfg, field)
        if val not in ok:
            raise NotImplementedError(
                f"RenderConfig.{field}={val!r} is not ported: ROADMAP "
                f"{item}; supported: {list(ok)}")


class _Routes(NamedTuple):
    """The bounce functions a render resolved (``None``: not on this
    render's routes)."""

    fused: object        # kernel B, or its plain version
    multi: object        # kernel B-multi, k bounces per launch
    hit_sky: object      # kernel E, or its plain version
    scatter: object      # kernel F, or its plain version
    split_tail: bool     # kernel F below the floor too (scatter "auto")
    one_shot: str        # "chunk", "on", "staged" or "off"


def resolve_routes(cfg: RenderConfig, hit_scene, device, *, h_virt: int,
                   kpp: int, bin_box, own_hit_fn: bool = False) -> _Routes:
    """The reference's route resolution (its render_image_persistent).

    Kernel B (and kernel E) need a plain sphere scene (not the sphere
    grid), ``hit_kernel`` "auto" or "v7" and no caller's hit function
    (``own_hit_fn``); under "v4" and "v6" every above-floor bounce is the
    hit function (kernel A) plus the scatter.  The whole bounce is fused
    unless ``fuse_bounce="off"``, an explicit ``scatter_backend``, or pixel
    ids of 2^24 and up (the reference's ``mosaic_dims_ok``; the CUDA
    kernels divide integers exactly at any size, so here that limit only
    keeps the routes of the two packages the same).  Under the "jnp"
    backend the same routes run with the plain versions at their ends.

    The scatter + respawn of a split bounce: ``scatter_backend="pallas"``
    is kernel F above the floor (the torch chain below it, a one-shot
    conflict), "jnp" the torch scatter.  "auto" is kernel F at every size
    (``split_tail``) on the kernels backend wherever the render has no
    fused bounce and the pixel ids fit: one launch in place of the torch
    scatter, respawn and draws, the same bounce bit for bit, so that no
    image, one-shot form or draw moves.

    Kernel B-multi (``multi``) is set wherever kernel B is, unless
    ``multi_backend="xla"``.  At or below the floor the reference resolves
    "" to "xla", the torch chain; the batch loop (:class:`_Loop`) runs
    kernels B-multi and B there instead: the same bounces, bit for bit, in
    a fraction of the launches.  Above the floor only the sharded scheduler
    runs it, under "fused", as the reference's sharded scheduler does."""
    from .kernels import bounce as B
    from .kernels import hit_sky as E
    from .kernels import scatter as F
    from .kernels.dispatch import resolve_backend

    w = cfg.width
    kernels = resolve_backend(cfg, device) == "kernels"
    mosaic_dims_ok = (h_virt * w < (1 << 24)
                      and (kpp & (kpp - 1) == 0
                           or h_virt * w * kpp < (1 << 24)))
    pallas_scatter = cfg.scatter_backend == "pallas"
    if pallas_scatter and not mosaic_dims_ok:
        raise ValueError(
            "scatter_backend='pallas' needs pixel ids that fit the "
            "kernel's exact-division range (height*width*n_frames < "
            f"2^24; got {h_virt * w})")
    fuse_wanted = (cfg.fuse_bounce == "on"
                   or (cfg.fuse_bounce == "auto"
                       and cfg.scatter_backend == "auto" and mosaic_dims_ok))
    if cfg.fuse_bounce == "on" and not mosaic_dims_ok:
        raise ValueError(
            "fuse_bounce='on' needs pixel ids that fit the kernel's "
            "exact-division range (height*width*n_frames < 2^24; got "
            f"{h_virt * w})")
    v7 = (not own_hit_fn and isinstance(hit_scene, SphereTable)
          and cfg.hit_kernel in ("auto", "v7"))
    fused = multi = None
    if v7 and fuse_wanted:
        fused = B.bounce if kernels else B.bounce_plain
        if cfg.multi_backend != "xla":
            multi = B.bounce_multi if kernels else B.bounce_multi_plain
    elif cfg.fuse_bounce == "on":
        raise ValueError(
            "fuse_bounce='on' requires the fused bounce kernel, which needs "
            "a plain sphere scene and hit_kernel auto/v7 (got hit_kernel="
            f"{cfg.hit_kernel!r}, scene={type(hit_scene).__name__})")
    hit_sky = (E.hit_sky if kernels else E.hit_sky_plain) if v7 else None
    scatter = None
    if pallas_scatter:
        scatter = F.scatter_respawn if kernels else F.scatter_respawn_plain
    split_tail = (kernels and fused is None and mosaic_dims_ok
                  and cfg.scatter_backend == "auto")
    if split_tail:
        scatter = F.scatter_respawn
    # One shot: "auto" runs chunks that start at or below the floor whole
    # ("chunk"); "on" also hands an above-floor chunk's tail to the
    # finisher, "staged" to p_render_until stages.  Each needs bounces with
    # no host step between them: bin sorts, the triangle pass's working-set
    # sorts and the pallas scatter conflict ("auto" turns off; "on" and
    # "staged" raise, as in the reference).
    conflicts = [name for cond, name in (
        (bin_box is not None, "ray binning"),
        (_tri_rebin_active(cfg, hit_scene), "tri_rebin working-set sorts"),
        (pallas_scatter, "scatter_backend='pallas'")) if cond]
    one_shot = cfg.one_shot
    if one_shot in ("on", "staged") and conflicts:
        raise ValueError(f"one_shot={one_shot!r} conflicts with "
                         + ", ".join(conflicts))
    if one_shot == "auto":
        one_shot = "off" if conflicts else "chunk"
    return _Routes(fused, multi, hit_sky, scatter, split_tail, one_shot)


def fresh_state(pixel: torch.Tensor, s_base: torch.Tensor,
                s_quota: torch.Tensor) -> PathState:
    """Lanes with no path yet on ``pixel``'s device: the first respawn
    starts their samples."""
    n, device = pixel.shape[1], pixel.device
    f32 = dict(dtype=torch.float32, device=device)
    direction = torch.zeros((3, n), **f32)
    direction[2] = 1.0
    return PathState(
        origin=torch.zeros((3, n), **f32),
        direction=direction,
        time=torch.zeros((1, n), **f32),
        throughput=torch.ones((3, n), **f32),
        radiance_sum=torch.zeros((3, n), **f32),
        depth=torch.zeros((1, n), dtype=torch.int32, device=device),
        sample=torch.full((1, n), -1, dtype=torch.int32, device=device),
        pixel=pixel,
        path_alive=torch.zeros((1, n), dtype=torch.bool, device=device),
        s_base=s_base,
        s_quota=s_quota,
    )


class _Phase(NamedTuple):
    """One lane batch's encoding and step limits: ``dims`` (its kpp is the
    pixel-lane id stride, 1 for raw pixel ids), the first alive check and
    the step cap."""

    dims: Dims
    first_check: int
    max_steps: int


def _adaptive_phase(cfg: RenderConfig, kpp: int) -> _Phase:
    """The adaptive second phase's batch: the samples left after the
    prepass's ``kpp``, on raw pixel ids."""
    rest = cfg.samples - kpp
    return _Phase(make_dims(cfg, cfg.width, cfg.height, cfg.samples, 1),
                  rest // min(cfg.kpp_max, rest) + 2,
                  (rest + 1) * (cfg.max_depth + 2))


def chunk_salt(seed: int, y0: int) -> int:
    """The draw salt of the chunk that starts at row ``y0`` (a rank's: its
    rank in place of ``y0``)."""
    return (seed * 0x9E3779B1 ^ (y0 + 1) * 0x85EBCA77) & 0xFFFFFFFF


def phase2_salt(salt: int) -> int:
    """The adaptive second phase's salt of a chunk or rank."""
    return (salt * 0x85EBCA77 + 0x632BE5AB) & 0xFFFFFFFF


def _pool_est(est: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``adaptive_pool="on"``'s transform of the prepass estimate over the
    chunk's (rows, width): max(raw, 3x3 box mean)^1.2, the box over an edge
    pad.  The box only raises an estimate (a blur would dilute the hard
    pixels the tail is made of); the exponent over-allocates against the
    estimate's regression to the mean."""
    img = est.reshape(h, w).to(torch.float32)
    pad = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1),
                                  mode="replicate")[0, 0]
    box = sum(pad[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))
    return torch.pow(torch.maximum(img, _div(box, 9)), 1.2).reshape(-1)


class _Render(NamedTuple):
    """What :func:`_prepare` resolved for one render, for either entry."""

    cam: Camera             # frame-stacked for a list of cameras
    cams: Optional[list]    # the list of cameras, or None
    cam_rows: torch.Tensor  # ``cam`` packed for the kernels
    h_virt: int             # height * frames
    hit_scene: object
    hit_fn: object
    bin_box: Optional[tuple]
    kpp: int
    quota: int
    adaptive: bool
    routes: _Routes
    uniform: _Phase         # the uniform layout's encoding and limits
    state_sorted: bool      # lanes stay in ascending pixel order


def _prepare(scene, cam, cfg: RenderConfig, hit_fn, device) -> _Render:
    """Resolve a render of ``scene`` (on ``device``) for either entry: the
    cameras (a LIST renders its frames as one virtual image of F * height
    rows, :func:`render_image_persistent`), the hit scene, the bin box,
    the lanes per pixel, the routes, and the checks on ``cfg``."""
    from .kernels.bounce import pack_camera, pack_cameras, unpack_camera
    from .kernels.dispatch import get_hit_fn_rows_accel

    check_supported(cfg, scene)
    cams, n_frames = None, 1
    if isinstance(cam, (list, tuple)) and not isinstance(cam, Camera):
        cams = [c.to(device) for c in cam]
        n_frames = len(cams)
        if n_frames == 0:
            raise ValueError("empty camera list")
        if n_frames == 1:
            cam = cams[0]
    if cam is None:
        cam = default_camera(cfg.width, cfg.height)
    w, h, spp = cfg.width, cfg.height, cfg.samples
    h_virt = h * n_frames   # frames stack as a taller image
    if n_frames > 1:
        cam_rows = pack_cameras(cams)
        cam = unpack_camera(cam_rows)
    else:
        cam = cam.to(device)
        cam_rows = pack_camera(cam)
    # The hit scene: the sphere table or grid, the triangle table or grid,
    # or a composite of those (kernels/dispatch.py).  A caller's hit
    # function is called on ``scene`` as passed.
    own_hit_fn = hit_fn is not None
    if own_hit_fn:
        hit_scene = scene
    else:
        hit_scene, hit_fn = get_hit_fn_rows_accel(
            cfg, scene, cams[0] if cams else cam)
    bin_box = _derive_bin_box(cfg, hit_scene)

    if cfg.compact_quantum < 0:
        raise ValueError(f"compact_quantum must be >= 0 (0 = auto), got "
                         f"{cfg.compact_quantum}")
    if not (cfg.compact_shrink == 0.0 or 0.0 < cfg.compact_shrink < 1.0):
        raise ValueError(f"compact_shrink must be 0 (auto) or in (0, 1), "
                         f"got {cfg.compact_shrink}")
    kpp = _resolve_kpp(cfg, spp, n_frames, w * h)
    if h_virt * w * kpp >= (1 << 29):
        raise ValueError(
            f"pixel-lane ids must stay below 2^29 "
            f"(width*height*frames*lanes_per_pixel = {h_virt * w * kpp})")
    # Difficulty-adaptive allocation (adaptive.py): a quota-1 prepass
    # measures each pixel's path length, then the remaining samples run on
    # lanes allocated by it, raw pixel ids (the replicas live in s_base and
    # s_quota).
    adaptive = (cfg.adaptive_alloc == "on" and kpp > 1 and spp > kpp
                and bin_box is None)
    if cfg.adaptive_alloc == "on" and not adaptive:
        raise ValueError(
            "adaptive_alloc='on' needs an unbinned render with "
            "lanes_per_pixel > 1 and samples > lanes_per_pixel "
            f"(got kpp={kpp}, samples={spp}, "
            f"ray_binning={'active' if bin_box else 'off'})")
    if cfg.adaptive_pool not in ("auto", "on", "off"):
        raise ValueError(
            f"adaptive_pool must be auto|on|off, got {cfg.adaptive_pool!r}")
    routes = resolve_routes(cfg, hit_scene, device, h_virt=h_virt, kpp=kpp,
                            bin_box=bin_box, own_hit_fn=own_hit_fn)
    quota = spp // kpp
    return _Render(
        cam, cams, cam_rows, h_virt, hit_scene, hit_fn, bin_box, kpp, quota,
        adaptive, routes,
        uniform=_Phase(make_dims(cfg, w, h, spp, kpp), quota + 2,
                       (quota + 1) * (cfg.max_depth + 2)),
        # Binning breaks the pixel order the argsort-free flush needs.
        state_sorted=bin_box is None and h_virt * w * kpp < _SORT_PIX_LIM)


def _count_one(alive: torch.Tensor):
    """One card's alive-count read (:func:`_alive_count`): a callable that
    waits for (the batch's count, the worst count), the same number."""
    read = _alive_count(alive)
    return lambda: (read(),) * 2


class _Loop:
    """The persistent batch loop of one render, for either entry: the
    bounce stepper (the route rule and the bin sort), the compaction
    engine, the one-shot and staged tails, and the check / compact / split
    loop.  The sharded entry passes what differs across ranks: its
    ``floor`` and ``min_lanes`` (one card's: ``_COMPACT_FLOOR`` and
    ``_MIN_LANES``); the ``ranks`` in lockstep (the first plateau test
    reads ``ranks`` times the batch); ``start_count(alive)``, which starts
    the count read and returns a callable that waits for (this rank's
    count, the worst rank's); ``stage_sync(step, count)``, (the latest
    step, the worst count) after a stage of the staged tail;
    ``multi_above``, kernel B-multi above the floor too (under
    ``multi_backend="fused"``); and ``floor_kernel``, the reference's rule
    that a batch of exactly ``floor`` lanes with no kernel tail (neither
    kernel B-multi nor kernel F below the floor) takes kernel B or the
    split bounce for the single steps after its torch k-bounces.
    ``receivers`` (redistribute="on") is one card's."""

    def __init__(self, r: _Render, cfg: RenderConfig, *, floor: int,
                 min_lanes: int, ranks: int = 1, start_count=_count_one,
                 stage_sync=None, receivers: bool = False,
                 multi_above: bool = False, floor_kernel: bool = False):
        self.r, self.cfg = r, cfg
        self.floor, self.min_lanes, self.ranks = floor, min_lanes, ranks
        self.start_count = start_count
        self.stage_sync = stage_sync or (lambda step, cnt: (step, cnt))
        self.receivers = receivers
        self.multi_above, self.floor_kernel = multi_above, floor_kernel
        # Flags: the bound method kept here would be a reference cycle.
        self.has_tail = r.routes.multi is not None
        self.kernel_tail = self.has_tail or r.routes.split_tail
        self.use_route = (cfg.compactor or "sort") == "route"
        self.flush_mode = cfg.flush_mode or "scatter"
        self.check_period = cfg.check_period or 8
        self.mk = cfg.multi_k or _MULTI_K
        self.shrink = cfg.compact_shrink or _COMPACT_SHRINK
        # Stratify off and roulette off are identities the steps can drop.
        self.lean = (not (cfg.stratify and cfg.samples > 1)
                     and not cfg.russian_roulette)
        # While the render records, has kernel B and stratifies or plays
        # the roulette: its counters (BOUNCE_STATS), one buffer that kernels
        # B and B-multi, their plain versions and the torch chain add into,
        # read once at the render's end; None otherwise.  A lean render
        # kills no path, and without the buffer's fill and copy its trace
        # keeps the launches it had before the counters.
        self.stats = (profiling.device_counters(BOUNCE_STATS, 2,
                                                r.cam_rows.device)
                      if r.routes.fused is not None and not self.lean
                      else None)

    def fused_tail(self, st, salt, step0, k, dims):
        """``k`` bounces at steps step0..step0+k-1: runs of ``mk`` on kernel
        B-multi, the rest on kernel B."""
        r, cfg = self.r, self.cfg
        while k >= self.mk:
            st = r.routes.multi(r.hit_scene, r.cam_rows, st, salt, step0, dims,
                                cfg=cfg, k=self.mk, lean=self.lean,
                                stats=self.stats)
            step0, k = step0 + self.mk, k - self.mk
        for step in range(step0, step0 + k):
            st = r.routes.fused(r.hit_scene, r.cam_rows, st, salt, step, dims,
                                cfg=cfg, lean=self.lean, stats=self.stats)
        return st

    def do_steps(self, st, k, step, salt, dims):
        """``k`` bounces after ``step``; returns (state, step).  Above the
        floor: kernel B or the split bounce (:meth:`_kernel_steps`).  At or
        below it: the kernel tail (:meth:`tail_bounces`) where the render
        has one, else the torch chain (:meth:`_torch_steps`), which
        ``floor_kernel`` parts at the floor.  Spans go by the floor (every
        bounce at or below it is "persistent.bounce_tail"), counters by
        route: kernel B, B-multi and the split bounce above the floor are
        "kernel", kernels B-multi and B below it "tail_fused", the split
        bounce and the torch steps below it "tail"."""
        if k <= 0:
            return st, step
        width = st.pixel.shape[1]
        if width > self.floor:
            return self._kernel_steps(st, k, step, salt, dims)
        if self.kernel_tail:
            with span("persistent.bounce_tail"):
                st = self.tail_bounces(st, salt, step + 1, k, dims)
            return st, step + k
        if self.floor_kernel and width == self.floor:
            n = 0 if self.r.bin_box is not None else k - k % self.mk
            if n:
                st, step = self._torch_steps(st, n, step, salt, dims)
            if n == k:
                return st, step
            return self._kernel_steps(st, k - n, step, salt, dims)
        return self._torch_steps(st, k, step, salt, dims)

    def _bin(self, st, step):
        """The bin sort before bounce ``step`` of a binned render."""
        box = self.r.bin_box
        if box is not None and (step - 1) % _BIN_PERIOD == 0:
            st = _bin_sort_core(st, box=box)
        return st

    def _kernel_steps(self, st, k, step, salt, dims):
        """``k`` single steps of kernel B, or the split bounce; under
        ``multi_above`` kernels B-multi and B."""
        r, cfg, width = self.r, self.cfg, st.pixel.shape[1]
        with span("persistent.bounce_kernel"):
            if self.multi_above and self.has_tail:
                st = self.fused_tail(st, salt, step + 1, k, dims)
            else:
                for s in range(step + 1, step + k + 1):
                    st = self._bin(st, s)
                    if r.routes.fused is not None:
                        st = r.routes.fused(r.hit_scene, r.cam_rows, st, salt,
                                            s, dims, cfg=cfg, lean=self.lean,
                                            stats=self.stats)
                    else:
                        st = self._split_bounce(st, salt, s, dims)
        count("persistent.steps_kernel", k)
        count("persistent.lanes_kernel", k * width)
        if r.routes.fused is None:
            count("persistent.scatter_kernel" if r.routes.scatter is not None
                  else "persistent.scatter_torch", k)
        return st, step + k

    def tail_bounces(self, st, salt, step0, k, dims):
        """``k`` bounces at or below the floor at steps step0..step0+k-1 on
        the kernel tail, counted: kernels B-multi and B where the render
        has them, else the split bounce on kernel F (the bin sort before
        each bounce of a binned render), with no host read between the
        bounces.  The batch loop's, the one-shot's and the staged tail's
        hook (``tail``)."""
        if self.has_tail:
            count("persistent.steps_tail_fused", k)
            count("persistent.lanes_tail_fused", k * st.pixel.shape[1])
            return self.fused_tail(st, salt, step0, k, dims)
        count_tail(k, st.pixel.shape[1], "kernel")
        for s in range(step0, step0 + k):
            st = self._split_bounce(self._bin(st, s), salt, s, dims)
        return st

    def _split_bounce(self, st, salt, step, dims):
        """A bounce with no fused kernel: hit (+ sky: kernel E, or the hit
        function), then scatter + respawn (kernel F, or torch)."""
        r, cfg = self.r, self.cfg
        if r.routes.hit_sky is not None:
            rec, st = r.routes.hit_sky(r.hit_scene, st, cfg=cfg)
        else:
            rec, st = p_hit_step(r.hit_scene, st, cfg=cfg, hit_fn=r.hit_fn)
        if r.routes.scatter is not None:
            return r.routes.scatter(r.cam_rows, st, rec, salt, step, dims,
                                    cfg=cfg, lean=self.lean)
        return p_scatter_respawn_step(r.cam, st, rec, salt, step, dims,
                                      cfg=cfg, lean=self.lean)

    def _torch_steps(self, st, k, step, salt, dims):
        """``k`` bounces of the torch chain (a render with no kernel tail):
        ``mk`` at a time when unbinned (a k-bounce would run on stale
        bins), then single steps."""
        r, cfg = self.r, self.cfg
        with span("persistent.bounce_tail"):
            count_tail(k, st.pixel.shape[1])
            if r.bin_box is None:
                while k >= self.mk:
                    st = p_bounce_multi_step(r.hit_scene, r.cam, st, salt,
                                             step + 1, dims, cfg=cfg,
                                             hit_fn=r.hit_fn, k=self.mk,
                                             lean=self.lean, stats=self.stats)
                    step, k = step + self.mk, k - self.mk
            for _ in range(k):
                step += 1
                st = p_bounce_step(r.hit_scene, r.cam, self._bin(st, step),
                                   salt, step, dims, cfg=cfg, hit_fn=r.hit_fn,
                                   lean=self.lean, stats=self.stats)
        return st, step

    def respawn(self, st, salt, dims):
        with span("persistent.respawn"):
            return p_respawn_step(self.r.cam, st, salt, 0, dims, cfg=self.cfg,
                                  lean=self.lean)

    def compact(self, st, accum, ph, *, k_new, tail_sorted=False,
                n_receivers=0, split=False):
        """The compaction engine (cfg.compactor): the route compactor puts
        the live lanes where the sort compactor does, so it is a cost knob;
        receiver events keep the sort engine.  ``split`` then halves the
        sample tails onto clone lanes (:func:`_split`)."""
        kpp = ph.dims.kpp
        count("persistent.compactions")
        with span("persistent.compact"):
            if self.use_route and n_receivers == 0:
                st, accum = _compact_route(st, accum, k_new=k_new,
                                           lanes_per_pixel=kpp)
            else:
                st, accum = _compact(st, accum, k_new=k_new,
                                     lanes_per_pixel=kpp,
                                     tail_sorted=tail_sorted,
                                     n_receivers=n_receivers,
                                     flush=self.flush_mode)
            return (_split(st) if split else st), accum

    def _tail(self):
        return self.tail_bounces if self.kernel_tail else None

    def one_shot(self, st, salt, step, ph):
        r = self.r
        with span("persistent.one_shot"):
            return p_render_oneshot(r.hit_scene, r.cam, st, salt, step,
                                    ph.dims, ph.max_steps, cfg=self.cfg,
                                    hit_fn=r.hit_fn, lean=self.lean,
                                    tail=self._tail(), stats=self.stats)

    def staged(self, st, accum, step, salt, ph):
        """The staged tail (one_shot="staged"): p_render_until stages that
        end when the alive count reaches the power of two at or below half
        the batch (where the host loop's compact + split first fires), each
        followed by that compact + split, sized by the worst rank; a batch
        of 2 * min_lanes or less runs to its end as one shot.  Ranks part
        within a stage; all re-enter at the latest exit step
        (``stage_sync``), so no rank repeats a draw."""
        r = self.r
        with span("persistent.staged"):
            while step < ph.max_steps:
                cur = st.pixel.shape[1]
                if cur <= 2 * self.min_lanes:
                    st = self.one_shot(st, salt, step, ph)
                    break
                target = 1 << (max(cur // 2, 1).bit_length() - 1)
                st, step, n_alive = p_render_until(
                    r.hit_scene, r.cam, st, salt, step, target, ph.dims,
                    ph.max_steps, cfg=self.cfg, hit_fn=r.hit_fn,
                    lean=self.lean, tail=self._tail(), stats=self.stats)
                step, worst = self.stage_sync(step, n_alive)
                if worst == 0 or step >= ph.max_steps:
                    break
                k_new = max(self.min_lanes, _next_pow2(worst))
                st, accum = self.compact(st, accum, ph, k_new=k_new,
                                         split=True)
            return st, accum

    def prepass(self, lanes, accum, salt, ascending=False):
        """The adaptive prepass: quota-1 ``lanes`` (pixel, s_base and
        s_quota rows) run max_depth + 1 bounces, within which every path
        ends, with no count read and no compaction, and their radiance is
        flushed into ``accum``.  Returns the final state: its depth row, in
        lane order, is each sample's path length."""
        dims = self.r.uniform.dims
        with span("persistent.prepass"):
            st = self.respawn(fresh_state(*lanes), salt, dims)
            st, _ = self.do_steps(st, self.cfg.max_depth + 1, 0, salt, dims)
            _flush(accum, st.pixel[0] // dims.kpp, st.radiance_sum,
                   ascending=ascending)
        return st

    def run_batch(self, lanes, accum, salt, ph, state_sorted, whole):
        """One lane batch from fresh ``lanes`` (pixel, s_base and s_quota
        rows) to its end (:meth:`run_loop`); returns ``accum`` with the
        batch's radiance flushed into it."""
        st = self.respawn(fresh_state(*lanes), salt, ph.dims)
        st, accum = self.run_loop(st, accum, salt, ph, state_sorted, whole)
        with span("persistent.flush"):
            return _flush(accum, st.pixel[0] // ph.dims.kpp, st.radiance_sum)

    def run_loop(self, st, accum, salt, ph, state_sorted, whole):
        """The check / compact / split loop for one lane batch.  ``whole``:
        a batch that starts at or below the floor runs whole in the one-shot
        forms.  Under one_shot "on" or "staged" the batch's tail below the
        floor goes to the finisher or the stages."""
        r, cfg, floor = self.r, self.cfg, self.floor
        one_shot = r.routes.one_shot
        cur = st.pixel.shape[1]
        if whole and cur <= floor:
            if one_shot == "staged":
                return self.staged(st, accum, 0, salt, ph)
            if one_shot in ("chunk", "on"):
                return self.one_shot(st, salt, 0, ph), accum
        step = 0
        period = self.check_period
        last_alive = self.ranks * cur
        first_check, max_steps = ph.first_check, ph.max_steps
        while step < max_steps:
            next_check = first_check if step < first_check else step + period
            st, step = self.do_steps(st, min(next_check, max_steps) - step,
                                     step, salt, ph.dims)
            cur = st.pixel.shape[1]
            # Read the counts behind a few optimistic bounces: alive is
            # monotone within a batch, so stale counts are upper bounds.
            pending = self.start_count(st.path_alive)
            ov = 1 if cur >= (1 << 21) else (2 if cur >= (1 << 20) else 4)
            st, step = self.do_steps(st, min(ov, max_steps - step), step,
                                     salt, ph.dims)
            with span("persistent.count_read"):
                n_alive, worst = pending()
            count("persistent.alive_at_reads", n_alive)
            count("persistent.width_at_reads", cur)
            if worst == 0:
                break
            # Back off while the alive count plateaus.
            if cur < floor:
                period = max(32, self.check_period)
            elif worst > 0.9 * last_alive:
                period = min(period * 2, max(32, self.check_period))
            else:
                period = self.check_period
            last_alive = worst
            if cur <= floor:
                if one_shot == "staged":
                    return self.staged(st, accum, step, salt, ph)
                # Bounce cost no longer shrinks with the batch: drop dead
                # lanes and halve the sequential sample tails instead.
                k_new = max(self.min_lanes, _next_pow2(worst))
                if k_new <= cur // 2:
                    st, accum = self.compact(st, accum, ph, k_new=k_new,
                                             split=True)
                if one_shot == "on":
                    # The tail finisher: the rest of the batch with no
                    # compaction and no count read but its own.
                    return self.one_shot(st, salt, step, ph), accum
                continue
            # Above the floor: compact on a shrink.  Under redistribute
            # "on" the batch overshoots so that its spare dead lanes adopt
            # donors' unstarted samples (after which the pixel order is
            # gone).
            k_base = _grid_size(worst, self.min_lanes, cfg.compact_quantum)
            if k_base <= int(cur * self.shrink):
                k_new, n_recv = k_base, 0
                if self.receivers:
                    k_new = min(_grid_size(int(worst * _RECV_OVERSHOOT),
                                           self.min_lanes,
                                           cfg.compact_quantum), cur)
                    spare = k_new - worst
                    if spare >= _RECV_MIN:
                        n_recv = min(1 << (spare.bit_length() - 1), k_new // 2)
                    else:
                        k_new = k_base
                st, accum = self.compact(st, accum, ph, k_new=k_new,
                                         tail_sorted=state_sorted,
                                         n_receivers=n_recv)
                if n_recv:
                    state_sorted = False
        return st, accum


@profiling.render_entry("persistent.render")
def render_image_persistent(scene: Scene, cam, cfg: RenderConfig,
                            hit_fn=None, resume_accum=None,
                            resume_y0: int = 0,
                            chunk_callback=None) -> torch.Tensor:
    """Render the full image on the scene's device; returns linear radiance
    [H, W, 3] f32.  Bounces run through the kernels (cfg.backend "auto" or
    "pallas") or the plain torch ops ("jnp"); :func:`resolve_routes` picks
    which.  An explicit rows ``hit_fn(scene, o, d, t, min_t)`` is called on
    ``scene`` as passed (a GridScene, say), with no accel resolution and
    neither kernel B nor kernel E: every bounce is that hit function plus
    the scatter, as in the reference.

    Checkpoint hooks (utils/checkpoint.py): ``chunk_callback(accum,
    next_y0)`` runs after each row chunk's radiance is flushed, with the
    running [3, H*W] f32 accumulator and the first row not rendered yet;
    ``resume_accum`` and ``resume_y0`` continue a render from such a pair.
    A chunk's draws depend only on (seed, y0) and every flush adds in an
    order fixed by its stream, so a resumed render equals an uninterrupted
    one bit for bit.

    Multi-frame batches: a LIST of cameras renders len(cam) frames in one
    batch, a virtual image of F * height rows with one camera per frame;
    returns [F, H, W, 3].  A list of one camera renders as that camera."""
    device = scene.device
    r = _prepare(scene, cam, cfg, hit_fn, device)
    w, h, spp = cfg.width, cfg.height, cfg.samples
    kpp, h_virt = r.kpp, r.h_virt
    loop = _Loop(r, cfg, floor=_COMPACT_FLOOR, min_lanes=_MIN_LANES,
                 receivers=cfg.redistribute == "on")
    rows = max(1, min(h_virt, cfg.rays_per_chunk // max(1, w * kpp)))
    if resume_accum is not None:
        accum = torch.as_tensor(resume_accum, dtype=torch.float32,
                                device=device).clone()
        if tuple(accum.shape) != (3, h_virt * w):
            raise ValueError(f"resume_accum has shape {tuple(accum.shape)}, "
                             f"this render's accumulator {(3, h_virt * w)}")
    else:
        accum = torch.zeros((3, h_virt * w), dtype=torch.float32,
                            device=device)
    i32 = dict(dtype=torch.int32, device=device)
    for y0 in range(resume_y0, h_virt, rows):
        take = min(rows, h_virt - y0)
        with span("persistent.chunk"):
            n_real = take * w * kpp
            # Pad the chunk onto the size grid with dead zero-quota lanes
            # that repeat the last pixel id (ascending order survives).
            n = _grid_size(n_real, _MIN_LANES, cfg.compact_quantum)
            base = y0 * w * kpp
            pixel = torch.arange(base, base + n, **i32).clamp_max(
                base + n_real - 1)[None]
            s_quota = torch.full((1, n), 1 if r.adaptive else r.quota, **i32)
            s_quota[:, n_real:] = 0
            lane_rank = torch.arange(n, **i32) % kpp
            salt = chunk_salt(cfg.seed, y0)
            if r.adaptive:
                # Phase 1, the prepass: kpp quota-1 lanes a pixel, in pixel
                # order.
                st = loop.prepass((pixel, lane_rank[None], s_quota), accum,
                                  salt, ascending=True)
                est = st.depth[0, :n_real].reshape(take * w, kpp).sum(
                    1, dtype=torch.int32)
                if cfg.adaptive_pool == "on":
                    est = _pool_est(est, take, w)
                # Phase 2: the remaining samples on difficulty-proportional
                # lanes, the same budget (the filler lanes take real work
                # too), raw pixel ids.
                pix2, s_base2, s_quota2 = alloc_lanes(
                    est, n_lanes=n, spp_done=kpp, spp=spp,
                    kpp_max=cfg.kpp_max)
                # The whole-chunk one shot is skipped here; the tail forms
                # stay.
                salt = phase2_salt(salt)
                accum = loop.run_batch((pix2 + y0 * w, s_base2, s_quota2),
                                       accum, salt, _adaptive_phase(cfg, kpp),
                                       r.state_sorted, whole=False)
            else:
                accum = loop.run_batch(
                    (pixel, (lane_rank * r.quota)[None], s_quota), accum, salt,
                    r.uniform, r.state_sorted, whole=True)
        if chunk_callback is not None:
            chunk_callback(accum, y0 + take)

    out = _div(accum, spp).T.reshape(h_virt, w, 3)
    return out if r.cams is None else out.reshape(len(r.cams), h, w, 3)
