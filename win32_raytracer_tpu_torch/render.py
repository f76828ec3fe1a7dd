"""Wavefront renderer, render entry point and tonemap
(``win32_raytracer_tpu.render``).

The reference's recursive ``getColor`` (RayTracer.cpp:392-704, depth
limited to MAX_RECURSION=10) becomes an iterative wavefront over a whole
``[N]`` batch of lanes carrying (origin, direction, time, throughput,
radiance, alive), in column layout ([N, 3] vectors).  Termination as in
the reference:

* a miss at depth <= max_depth adds the sky gradient scaled by the
  throughput (RayTracer.cpp:690-701);
* a metal absorb is black (RayTracer.cpp:625-628);
* a path still alive after depth max_depth is black (RayTracer.cpp:
  399-402): max_depth + 1 scatter events.

Every lane is swept at every bounce, dead ones included; there is no
compaction (that is the persistent scheduler's).  Each bounce is the hit
function (kernel G for spheres, kernel H for triangles on a card; their
plain versions on the CPU; kernels/dispatch.get_hit_fn), then the sky and
the scatter as torch ops.  Draws are ``jax.random``'s threefry, bit for
bit: the key of the seed, folded with the chunk's first row on the host,
then 1 for the camera draws and 2 for the bounce draws, then the depth;
one launch of the draw kernel each where the hit takes the kernels
(``kernels/draws.py``), core/rng.py's int64 torch ops under
``backend="jnp"``.  ``deterministic`` sets every draw to 0.5 (the shutter
time to 0).

The per-tile pixel loop (``generateImage``, RayTracer.cpp:894-959) becomes
:func:`render_image`: pixel/sample lanes flattened to ``[rows*W*spp]``
chunks, mean over samples, then :func:`tonemap`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .config import RenderConfig, resolve_scheduler
from .core.materials import sky_color
from .core.rng import fold_in, prng_key
from .core.vec import sqrt_rn
from .kernels import draws as draw_kernel
from .kernels.dispatch import resolve_backend
from .ops.scatter import scatter
from .persistent import Scene, _div
from .scene.camera import Camera, camera_rays, default_camera
from .utils import profiling

HitFn = Callable[..., object]


class WavefrontState(NamedTuple):
    """Per-lane path state carried across bounces (on the scene's device)."""

    origin: torch.Tensor      # [N, 3]
    direction: torch.Tensor   # [N, 3]
    time: torch.Tensor        # [N]
    throughput: torch.Tensor  # [N, 3]
    radiance: torch.Tensor    # [N, 3]
    alive: torch.Tensor       # [N] bool


def _fresh_state(origin, direction, time) -> WavefrontState:
    n, dev = origin.shape[0], origin.device
    return WavefrontState(
        origin=origin, direction=direction, time=time,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev))


def _uniform01(key: tuple, shape, *, cfg: RenderConfig, device) -> torch.Tensor:
    """The wavefront's draws, ``jax.random.uniform(key, shape)``: the draw
    kernel's wrapper where ``resolve_backend`` gives "kernels" (the rule
    that picks the hit kernels), the plain int64 torch ops otherwise."""
    if resolve_backend(cfg, device) == "kernels":
        return draw_kernel.uniform01(key, shape, device)
    return draw_kernel.uniform01_plain(key, shape, device)


def make_primary_rays(cam: Camera, y0: int, key: tuple, *, cfg: RenderConfig,
                      width: int, height: int, spp: int,
                      rows: int) -> WavefrontState:
    """Camera rays for ``rows`` image rows from global row ``y0``: jitter
    and mapping of ``generateImage`` (RayTracer.cpp:934-944), u = (x + r0)
    / W, v = (H - y + r1) / H (the reference's flip is H - y, not
    H - 1 - y).  Lanes run row, then column, then sample."""
    dev = cam.origin.device
    n = rows * width * spp
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    y = y0 + lane // (width * spp)
    x = (lane // spp) % width
    if cfg.deterministic:
        draws = torch.full((n, 5), 0.5, dtype=torch.float32, device=dev)
        draws[:, 2] = 0.0   # shutter-open time
    else:
        draws = _uniform01(fold_in(key, 0), (n, 5), cfg=cfg, device=dev)
    u = _div(x.to(torch.float32) + draws[:, 0], width)
    v = _div((height - y).to(torch.float32) + draws[:, 1], height)
    return _fresh_state(*camera_rays(cam, u, v, draws[:, 2:5]))


def hit_step(scene, state: WavefrontState, *, cfg: RenderConfig,
             hit_fn: HitFn):
    """Bounce part 1: the nearest-hit sweep, and the sky on a live miss
    (RayTracer.cpp:690-701).  Returns (record, state)."""
    rec = hit_fn(scene, state.origin, state.direction, state.time,
                 min_t=cfg.min_hit_t)
    miss = state.alive & ~rec.hit
    rad = state.radiance + torch.where(
        miss[:, None], state.throughput * sky_color(state.direction), 0.0)
    return rec, state._replace(radiance=rad)


def scatter_step(scene, state: WavefrontState, rec, key: tuple, depth: int,
                 *, cfg: RenderConfig) -> WavefrontState:
    """Bounce part 2: the material scatter, the masked state update and
    (opt-in) Russian roulette from ``rr_start_depth``."""
    o, d, tm, thr, rad, alive = state
    n = o.shape[0]
    if cfg.deterministic:
        draws = torch.full((n, 5), 0.5, dtype=torch.float32, device=o.device)
    else:
        draws = _uniform01(fold_in(key, depth), (n, 5), cfg=cfg,
                           device=o.device)
    sc = scatter(scene, d, rec, draws, cfg)

    live_hit = alive & rec.hit
    lh = live_hit[:, None]
    thr = torch.where(lh, thr * sc.attenuation, thr)
    o = torch.where(lh, sc.origin, o)
    d = torch.where(lh, sc.direction, d)
    alive = live_hit & sc.alive

    if cfg.russian_roulette and depth >= cfg.rr_start_depth:
        p = torch.clamp(thr.amax(dim=-1), 0.05, 1.0)
        survive = draws[:, 4] < p
        thr = torch.where(alive[:, None], thr / p[:, None], thr)
        alive = alive & survive
    return WavefrontState(o, d, tm, thr, rad, alive)


def bounce_step(scene, state: WavefrontState, key: tuple, depth: int, *,
                cfg: RenderConfig, hit_fn: HitFn) -> WavefrontState:
    """One scatter event for the whole wavefront."""
    rec, state = hit_step(scene, state, cfg=cfg, hit_fn=hit_fn)
    return scatter_step(scene, state, rec, key, depth, cfg=cfg)


def accumulate_pixels(radiance: torch.Tensor, *, width: int, spp: int,
                      rows: int) -> torch.Tensor:
    """Mean over samples -> linear radiance [rows, W, 3]: the samples added
    in order, then one true division by spp."""
    r = radiance.reshape(rows, width, spp, 3)
    acc = r[:, :, 0]
    for s in range(1, spp):
        acc = acc + r[:, :, s]
    return _div(acc, spp)


def _resolve_hit(scene, cfg: RenderConfig, hit_fn: Optional[HitFn]):
    """(what the hit function reads, the hit function): the scene's
    tables and kernels/dispatch.get_hit_fn's function, or the scene and
    an explicit ``hit_fn``."""
    if hit_fn is not None:
        return scene, hit_fn
    from .kernels.dispatch import get_hit_fn, hit_tables
    return hit_tables(scene), get_hit_fn(cfg, scene.device, scene)


def trace(scene, origin: torch.Tensor, direction: torch.Tensor,
          time: torch.Tensor, key: tuple, cfg: RenderConfig,
          hit_fn: Optional[HitFn] = None) -> torch.Tensor:
    """Trace [N] rays to completion; returns linear radiance [N, 3]."""
    hit_scene, hit_fn = _resolve_hit(scene, cfg, hit_fn)
    state = _fresh_state(origin, direction, time)
    # max_depth + 1 scatter events (depths 0..max_depth); survivors are black.
    for depth in range(cfg.max_depth + 1):
        state = bounce_step(hit_scene, state, key, depth, cfg=cfg,
                            hit_fn=hit_fn)
    return state.radiance


@profiling.render_entry("wavefront.render")
def render_image(scene: Scene, cam: Optional[Camera], cfg: RenderConfig,
                 hit_fn: Optional[HitFn] = None,
                 progress=None) -> torch.Tensor:
    """Render the whole image on the wavefront scheduler; returns linear
    radiance [H, W, 3] f32 on the scene's device.

    Rows go in chunks of max(1, min(H, rays_per_chunk // (W * spp))); the
    last chunk is traced whole and cut to the rows left.  Each chunk's
    draws fold the chunk's first row into the seed's key, so the image is
    fixed by (seed, chunk size).  ``hit_fn`` None resolves the hit
    function from ``cfg.backend`` (kernels/dispatch.get_hit_fn); an
    explicit one is called on ``scene`` as given.  ``progress`` takes the
    events of ``utils/progress.py``."""
    from .utils.progress import ProgressTracker

    dev = scene.device
    w, h, spp = cfg.width, cfg.height, cfg.samples
    cam = (default_camera(w, h, device=dev) if cam is None else cam.to(dev))
    rows = max(1, min(h, cfg.rays_per_chunk // max(1, w * spp)))
    key = prng_key(cfg.seed)
    # The seed only feeds the key, as in the reference.
    cfg = cfg.replace(seed=0)
    hit_scene, hit_fn = _resolve_hit(scene, cfg, hit_fn)
    tracker = ProgressTracker(h, w * spp, progress)

    out = []
    for y0 in range(0, h, rows):
        ckey = fold_in(key, y0)
        state = make_primary_rays(cam, y0, fold_in(ckey, 1), cfg=cfg,
                                  width=w, height=h, spp=spp, rows=rows)
        tkey = fold_in(ckey, 2)
        for depth in range(cfg.max_depth + 1):
            state = bounce_step(hit_scene, state, tkey, depth, cfg=cfg,
                                hit_fn=hit_fn)
        block = accumulate_pixels(state.radiance, width=w, spp=spp, rows=rows)
        take = min(rows, h - y0)
        out.append(block[:take])
        tracker.chunk_done(take)
    tracker.done()
    return torch.cat(out, dim=0)


def tonemap(linear: torch.Tensor) -> torch.Tensor:
    """Gamma-2 + u8 quantization (RayTracer.cpp:948-954)."""
    c = sqrt_rn(torch.clamp_min(linear, 0.0))
    return torch.clamp(torch.floor(255.99 * c), 0.0, 255.0).to(torch.uint8)


def render(scene: Scene, cam: Optional[Camera] = None,
           cfg: Optional[RenderConfig] = None,
           hit_fn: Optional[HitFn] = None) -> np.ndarray:
    """Render a sphere, triangle or composite scene to a u8 [H, W, 3] image
    (top row first) on the scene's device.  The scheduler follows
    ``config.resolve_scheduler``: the wavefront for deterministic renders
    and below 8 spp, else the persistent one.  ``hit_fn`` (a column hit
    function, called on ``scene`` as passed) replaces the resolved one; the
    persistent scheduler runs it through ``ops/rows.hit_rows_adapter``."""
    cfg = cfg or RenderConfig()
    if cam is None:
        cam = default_camera(cfg.width, cfg.height, device=scene.device)
    scheduler = resolve_scheduler(cfg)
    if scheduler == "persistent":
        from .ops.rows import hit_rows_adapter
        from .persistent import render_image_persistent
        linear = render_image_persistent(
            scene, cam, cfg,
            hit_fn=None if hit_fn is None else hit_rows_adapter(hit_fn))
    elif scheduler == "wavefront":
        linear = render_image(scene, cam, cfg, hit_fn=hit_fn)
    else:
        raise ValueError(
            f"unknown scheduler {cfg.scheduler!r} (auto|wavefront|persistent)")
    return tonemap(linear).cpu().numpy()
