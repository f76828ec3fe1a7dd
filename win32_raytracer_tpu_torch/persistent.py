"""Persistent scheduler with batch compaction, lane-major (PyTorch port).

The port of ``win32_raytracer_tpu.persistent`` for plain sphere scenes at
the default knobs.  Each lane owns one pixel replica and runs its quota of
samples one after another, respawning a camera sample the moment a path
ends; the host loop checks the alive count now and then, compacts dead
lanes out while the batch is above ``_COMPACT_FLOOR`` (a stable sort on
the (dead, pixel) key onto the mantissa size grid, the dropped tail's
radiance added into ``accum``), and below it splits unstarted samples onto
clone lanes.

Bounces: above the floor one call of the fused bounce kernel
(kernels/bounce.py); at or below it the sphere kernel (kernels/hit.py)
followed by the torch scatter and respawn here, as the reference runs its
XLA steps there.  Draws key on (salt, step, lane position) exactly as in
the reference, so the same schedule draws the same numbers.

State is [3, N] / [1, N] rows, as in the reference.  ``accum`` is updated
in place (``index_add_``), which saves a copy of the image per flush.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import RenderConfig
from .core.rng import hash_uniform01
from .ops.hit import SphereTable, sphere_table
from .ops.rows import HitRecordRows, camera_rays_rows, scatter_rows, sky_color_rows
from .scene.camera import Camera, default_camera
from .scene.spheres import SphereScene


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


def _hit_core(table: SphereTable, st: PathState, *, cfg: RenderConfig,
              hit_fn):
    rec: HitRecordRows = hit_fn(table, st.origin, st.direction, st.time,
                                min_t=cfg.min_hit_t)
    miss = st.path_alive & ~rec.hit
    rad = st.radiance_sum + torch.where(
        miss, st.throughput * sky_color_rows(st.direction), 0.0)
    return rec, st._replace(radiance_sum=rad,
                            path_alive=st.path_alive & rec.hit)


def _scatter_core(st: PathState, rec: HitRecordRows, salt, step_i,
                  dims: Dims, *, cfg: RenderConfig,
                  lean: bool = False) -> PathState:
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

    return st._replace(origin=o, direction=d, throughput=thr, depth=depth,
                       path_alive=alive)


def _div(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x / d``, rounded as a true division.  On a card torch turns
    division by a Python scalar into multiplication by its reciprocal,
    which differs in the last place from the reference and the kernels;
    a 0-dim tensor divisor keeps the true division."""
    return x / x.new_full((), float(d))


def _respawn_core(cam: Camera, st: PathState, salt, step_i, dims: Dims, *,
                  cfg: RenderConfig, lean: bool = False) -> PathState:
    """Start the next camera sample on every lane whose path just ended.
    Pixel-lane id -> (x, y) by true integer division."""
    del cfg
    n = st.pixel.shape[1]
    pd = st.pixel // dims.kpp
    y, x = pd // dims.width, pd % dims.width

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


def p_bounce_step(table: SphereTable, cam: Camera, st: PathState, salt,
                  step_i, dims: Dims, *, cfg: RenderConfig, hit_fn,
                  lean: bool = False) -> PathState:
    """Hit + scatter + respawn, one bounce."""
    rec, st = _hit_core(table, st, cfg=cfg, hit_fn=hit_fn)
    st = _scatter_core(st, rec, salt, step_i, dims, cfg=cfg, lean=lean)
    return _respawn_core(cam, st, salt, step_i, dims, cfg=cfg, lean=lean)


# Bounces per below-floor multi-step (cfg.multi_k = 0).
_MULTI_K = 4


def p_bounce_multi_step(table: SphereTable, cam: Camera, st: PathState, salt,
                        step0, dims: Dims, *, cfg: RenderConfig, hit_fn,
                        k: int = _MULTI_K, lean: bool = False) -> PathState:
    """``k`` bounces at steps step0..step0+k-1."""
    for i in range(k):
        st = p_bounce_step(table, cam, st, salt, step0 + i, dims, cfg=cfg,
                           hit_fn=hit_fn, lean=lean)
    return st


# p_render_oneshot reads the alive flag back once per this many bounces.
_ONESHOT_SYNC = 8


def p_render_oneshot(table: SphereTable, cam: Camera, st: PathState, salt,
                     step0: int, dims: Dims, max_steps: int, *,
                     cfg: RenderConfig, hit_fn,
                     lean: bool = False) -> PathState:
    """A whole lane chunk to completion: bounces step0+1.. until every lane
    is dead or ``max_steps``.  After a bounce a dead lane has spent its
    quota (the bounce's respawn would have revived it otherwise), so the
    bounces after the last lane dies change nothing; the alive flag is
    read only every ``_ONESHOT_SYNC`` bounces."""
    step = step0
    while step < max_steps:
        for _ in range(min(_ONESHOT_SYNC, max_steps - step)):
            step += 1
            st = p_bounce_step(table, cam, st, salt, step, dims, cfg=cfg,
                               hit_fn=hit_fn, lean=lean)
        if not bool(st.path_alive.any()):
            break
    return st


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _resolve_kpp(cfg: RenderConfig, spp: int) -> int:
    """cfg.lanes_per_pixel, or the auto choice: the largest of 8/4/2 that
    divides spp with a quota >= 4."""
    kpp = cfg.lanes_per_pixel
    if kpp <= 0:
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


def _compact(st: PathState, accum: torch.Tensor, *, k_new: int,
             lanes_per_pixel: int = 1, tail_sorted: bool = False):
    """Keep the live lanes (alive first, stable) in a [k_new] batch and add
    the dropped lanes' radiance into ``accum`` (in place).

    ``tail_sorted`` promises ascending pixel ids; the key is then the
    composite (dead, pixel), which keeps the compacted head ascending too.
    Dropped lanes are all dead (k_new >= alive count): their radiance is
    final."""
    key = (~st.path_alive[0]).to(torch.int32)
    if tail_sorted:
        key = key * _SORT_PIX_LIM + st.pixel[0]
    perm = torch.sort(key, stable=True).indices
    head, tail = perm[:k_new], perm[k_new:]
    new = PathState(*(x[:, head] for x in st))
    accum.index_add_(1, st.pixel[0, tail] // lanes_per_pixel,
                     st.radiance_sum[:, tail])
    return new, accum


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


def _alive_count(alive: torch.Tensor):
    """Start reading the alive count; returns a callable that waits for it.
    On a card the count is copied back behind an event, so the caller can
    queue more bounces before it waits."""
    cnt = alive.sum()
    if cnt.device.type != "cuda":
        return lambda: int(cnt)
    host = cnt.to("cpu", non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()

    def read():
        ready.synchronize()
        return int(host)
    return read


# Config values the port runs, and the ROADMAP item that ports the rest.
_SUPPORTED = {
    "scatter_backend": (("auto",), "Queue 1 item 7 (split path)"),
    "hit_kernel": (("auto", "v7"), "Queue 1 item 7 (split path)"),
    "fuse_bounce": (("auto", "on"), "Queue 1 item 7 (split path)"),
    "accel": (("auto", "off"), "Queue 1 item 10 (sphere grid)"),
    "ray_binning": (("auto", "off"), "Queue 1 items 9-10 (ray binning)"),
    "redistribute": (("auto", "off"), "Queue 1 item 7 (redistribute)"),
    "tri_tile_rows": ((0,), "Queue 1 item 9 (triangles)"),
    "tri_ray_block": ((0,), "Queue 1 item 9 (triangles)"),
    "tri_early_exit": (("auto",), "Queue 1 item 9 (triangles)"),
    "tri_any_skip": (("auto",), "Queue 1 item 9 (triangles)"),
    "tri_sub_gate": ((0,), "Queue 1 item 9 (triangles)"),
    "tri_gather": (("auto",), "Queue 1 item 9 (triangles)"),
    "tri_partition": (("auto",), "Queue 1 item 9 (triangles)"),
    "tri_rebin": (("auto", "off"), "Queue 1 item 9 (triangles)"),
    "tri_dda_k": ((0,), "Queue 1 item 9 (triangles)"),
    "one_shot": (("auto", "off"), "Queue 1 item 7 (one_shot on/staged)"),
    "multi_backend": (("", "xla"), "Queue 2 (p_bounce_multi_fused)"),
    "compactor": (("", "sort"), "Queue 1 item 7 (route compactor)"),
    "flush_mode": (("", "scatter"), "Queue 1 item 7 (window flush)"),
    "adaptive_alloc": (("off",), "Queue 1 item 8 (adaptive.py)"),
    "adaptive_pool": (("auto",), "Queue 1 item 8 (adaptive.py)"),
    "kpp_max": ((32,), "Queue 1 item 8 (adaptive.py)"),
    "pallas_interpret": ((False,), "'Not to port' (no interpret mode; "
                         "the plain versions run on the CPU)"),
}


def check_supported(cfg: RenderConfig) -> None:
    """Raise NotImplementedError for a knob value this port does not run."""
    for field, (ok, item) in _SUPPORTED.items():
        val = getattr(cfg, field)
        if val not in ok:
            raise NotImplementedError(
                f"RenderConfig.{field}={val!r} is not ported yet: ROADMAP "
                f"{item}; supported: {list(ok)}")


def render_image_persistent(scene: SphereScene, cam: Optional[Camera],
                            cfg: RenderConfig) -> torch.Tensor:
    """Render the full image on the scene's device; returns linear radiance
    [H, W, 3] f32.  Bounces run through the kernels (cfg.backend "auto" or
    "pallas") or the plain torch ops ("jnp")."""
    from .kernels.bounce import bounce, bounce_plain, pack_camera
    from .kernels.dispatch import get_hit_fn_rows, resolve_backend

    check_supported(cfg)
    if isinstance(cam, (list, tuple)) and not isinstance(cam, Camera):
        raise NotImplementedError(
            "multi-frame camera lists are not ported yet: ROADMAP Queue 1 "
            "item 7 (n_frames)")
    device = scene.device
    if cam is None:
        cam = default_camera(cfg.width, cfg.height)
    cam = cam.to(device)
    table = sphere_table(scene)
    hit_fn = get_hit_fn_rows(cfg, device)
    kernels = resolve_backend(cfg, device) == "kernels"
    fused = bounce if kernels else bounce_plain

    if cfg.compact_quantum < 0:
        raise ValueError(f"compact_quantum must be >= 0 (0 = auto), got "
                         f"{cfg.compact_quantum}")
    if not (cfg.compact_shrink == 0.0 or 0.0 < cfg.compact_shrink < 1.0):
        raise ValueError(f"compact_shrink must be 0 (auto) or in (0, 1), "
                         f"got {cfg.compact_shrink}")
    shrink = cfg.compact_shrink or _COMPACT_SHRINK
    w, h, spp = cfg.width, cfg.height, cfg.samples
    kpp = _resolve_kpp(cfg, spp)
    rows = max(1, min(h, cfg.rays_per_chunk // max(1, w * kpp)))
    # Stratify off and roulette off are identities the steps can drop.
    lean = not (cfg.stratify and spp > 1) and not cfg.russian_roulette
    if h * w * kpp >= (1 << 29):
        raise ValueError(
            f"pixel-lane ids must stay below 2^29 "
            f"(width*height*lanes_per_pixel = {h * w * kpp})")
    quota = spp // kpp
    check_period = cfg.check_period or 8
    first_check = quota + 2
    max_steps = (quota + 1) * (cfg.max_depth + 2)
    min_lanes = 1 << 12
    dims = make_dims(cfg, w, h, spp, kpp)
    cam_rows = pack_camera(cam)
    mk = cfg.multi_k or _MULTI_K
    one_shot = "chunk" if cfg.one_shot == "auto" else cfg.one_shot

    accum = torch.zeros((3, h * w), dtype=torch.float32, device=device)

    def do_steps(st, k, step, salt):
        tail = st.pixel.shape[1] <= _COMPACT_FLOOR
        if tail:
            while k >= mk:
                st = p_bounce_multi_step(table, cam, st, salt, step + 1,
                                         dims, cfg=cfg, hit_fn=hit_fn, k=mk,
                                         lean=lean)
                step += mk
                k -= mk
        for _ in range(k):
            step += 1
            if tail:
                st = p_bounce_step(table, cam, st, salt, step, dims, cfg=cfg,
                                   hit_fn=hit_fn, lean=lean)
            else:
                st = fused(table, cam_rows, st, salt, step, dims, cfg=cfg,
                           lean=lean)
        return st, step

    def run_loop(st, accum, salt, state_sorted):
        """The check / compact / split loop for one lane batch."""
        step = 0
        period = check_period
        last_alive = st.pixel.shape[1]
        while step < max_steps:
            next_check = first_check if step < first_check else step + period
            st, step = do_steps(st, min(next_check, max_steps) - step, step,
                                salt)
            cur = st.pixel.shape[1]
            # Read the count behind a few optimistic bounces: alive is
            # monotone within a chunk, so the stale count is an upper bound.
            pending = _alive_count(st.path_alive)
            ov = 1 if cur >= (1 << 21) else (2 if cur >= (1 << 20) else 4)
            st, step = do_steps(st, min(ov, max_steps - step), step, salt)
            n_alive = pending()
            if n_alive == 0:
                break
            # Back off while the alive count plateaus.
            if cur < _COMPACT_FLOOR:
                period = max(32, check_period)
            elif n_alive > 0.9 * last_alive:
                period = min(period * 2, max(32, check_period))
            else:
                period = check_period
            last_alive = n_alive
            if cur <= _COMPACT_FLOOR:
                # Bounce cost no longer shrinks with the batch: drop dead
                # lanes and halve the sequential sample tails instead.
                k_new = max(min_lanes, _next_pow2(n_alive))
                if k_new <= cur // 2:
                    st, accum = _compact(st, accum, k_new=k_new,
                                         lanes_per_pixel=kpp)
                    st = _split(st)
                continue
            k_new = _grid_size(n_alive, min_lanes, cfg.compact_quantum)
            if k_new <= int(cur * shrink):
                st, accum = _compact(st, accum, k_new=k_new,
                                     lanes_per_pixel=kpp,
                                     tail_sorted=state_sorted)
        return st, accum

    i32 = dict(dtype=torch.int32, device=device)
    for y0 in range(0, h, rows):
        take = min(rows, h - y0)
        n_real = take * w * kpp
        # Pad the chunk onto the size grid with dead zero-quota lanes that
        # repeat the last pixel id (ascending order survives).
        n = _grid_size(n_real, min_lanes, cfg.compact_quantum)
        base = y0 * w * kpp
        pixel = torch.arange(base, base + n, **i32).clamp_max(
            base + n_real - 1)[None]
        s_quota = torch.full((1, n), quota, **i32)
        s_quota[:, n_real:] = 0
        direction = torch.zeros((3, n), dtype=torch.float32, device=device)
        direction[2] = 1.0
        st = PathState(
            origin=torch.zeros((3, n), dtype=torch.float32, device=device),
            direction=direction,
            time=torch.zeros((1, n), dtype=torch.float32, device=device),
            throughput=torch.ones((3, n), dtype=torch.float32, device=device),
            radiance_sum=torch.zeros((3, n), dtype=torch.float32,
                                     device=device),
            depth=torch.zeros((1, n), **i32),
            sample=torch.full((1, n), -1, **i32),
            pixel=pixel,
            path_alive=torch.zeros((1, n), dtype=torch.bool, device=device),
            s_base=(torch.arange(n, **i32) % kpp * quota)[None],
            s_quota=s_quota,
        )
        salt = (cfg.seed * 0x9E3779B1 ^ (y0 + 1) * 0x85EBCA77) & 0xFFFFFFFF
        st = p_respawn_step(cam, st, salt, 0, dims, cfg=cfg, lean=lean)
        if one_shot == "chunk" and n <= _COMPACT_FLOOR:
            st = p_render_oneshot(table, cam, st, salt, 0, dims, max_steps,
                                  cfg=cfg, hit_fn=hit_fn, lean=lean)
        else:
            st, accum = run_loop(st, accum, salt,
                                 state_sorted=h * w * kpp < _SORT_PIX_LIM)
        # Flush this chunk's remaining radiance.
        accum.index_add_(1, st.pixel[0] // kpp, st.radiance_sum)

    return _div(accum, spp).T.reshape(h, w, 3)
