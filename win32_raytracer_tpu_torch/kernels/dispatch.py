"""Hit backend and acceleration selection (the reference's
``kernels/dispatch.py``): rows layout for the persistent scheduler,
columns (:func:`get_hit_fn`) for the wavefront.

``cfg.backend``: "auto" routes through the kernel wrappers, which launch
the CUDA kernels for tensors on a card and run their plain versions for
tensors on the CPU; "pallas" asks for the CUDA kernels and raises off a
card; "jnp" runs the plain torch ops on any device (the kernels' reference,
as the jnp path is the JAX package's).  Both take the same routes below;
only the functions at their ends differ.

Scene routing (:func:`get_hit_fn_rows_accel`), the reference's on its
Pallas backend:

* a plain sphere scene: kernel A (``kernels/hit.py``) under every
  ``hit_kernel`` (:func:`validate_hit_kernel`); under ``accel="grid"``,
  when ``accel.build_grid_accel`` qualifies it (built for the camera's
  shutter window), the sphere grid, kernel I's schedule kernel (pass A over
  the globals) then its sweep (``kernels/hit_grid.py``), with its counters
  and span while a render records (:func:`_sphere_grid_pass`); "auto"
  never picks the sphere grid, as in the reference.  Under "jnp" the grid
  runs its plain sweep (kernel I's plain version); the reference raises
  there instead;
* a triangle mesh with at least ``tri_accel.build_tri_grid``'s
  ``min_tris`` (512) active triangles, under ``accel`` "auto" or "grid":
  the Morton-tile grid, kernel D (``kernels/tri_grid.py``);
* a smaller mesh, or any mesh under ``accel="off"``: the brute sweep,
  kernel C (``kernels/tri.py``), each call span ``tri_brute.hit`` and its
  lanes counted in ``tri_brute.lanes`` while a render records
  (:func:`_tri_brute_pass`);
* a composite of spheres and a mesh: the sphere pass first, then the
  triangle pass, merged by ``ops/rows.combine_hits_rows`` with triangle
  indices after the spheres'.  On the grid the sphere pass's nearest t
  caps the triangle pass (``t_cap``): a sphere hit occludes every farther
  tile, so fewer tiles are scheduled.  The brute composite runs both
  sweeps whole, as the reference's does;
* the grid's triangle pass under ``tri_rebin`` "on" and "dda"
  (:func:`_make_tri_pass`): kernel D on the working set sorted by capped
  chord keys (``kernels/tri_rebin.py``) or on the lanes' DDA pair
  expansion (``kernels/tri_dda.py``), the record put back in lane order.

The wavefront scheduler's column hit functions (:func:`get_hit_fn`) have
no grid, as in the reference: spheres go to kernel G
(``kernels/hit_cols.py``), meshes to the brute kernel H
(``kernels/tri_cols.py``), composites to both through
``scene/composite.make_hit_fn``.
"""

from __future__ import annotations

import functools

import torch

from ..accel import build_grid_accel, hit_spheres_grid_rows_plain
from ..config import MIN_HIT_T, SHUTTER_CLOSE_T, RenderConfig
from ..ops.hit import SphereTable, hit_spheres, sphere_table
from ..ops.hit_tri import hit_triangles, tri_table
from ..ops.rows import combine_hits_rows
from ..scene.composite import CompositeScene, make_hit_fn
from ..scene.spheres import SphereScene
from ..scene.triangles import TriangleScene
from ..tri_accel import (
    DEFAULT_TILE_ROWS, DEFAULT_TRI_GRID_RAY_BLOCK, build_tri_grid,
    hit_triangles_grid_rows_plain,
)
from ..utils import profiling
from .hit import hit_spheres_rows, hit_spheres_rows_plain
from .hit_cols import hit_spheres_cols
from .hit_grid import hit_spheres_grid_rows
from .tri import hit_triangles_rows, hit_triangles_rows_plain
from .tri_cols import hit_triangles_cols
from .tri_dda import dda_tri_pass
from .tri_grid import hit_triangles_grid_rows
from .tri_rebin import sorted_tri_pass


def resolve_backend(cfg: RenderConfig, device) -> str:
    """"kernels" or "plain".

    "plain" comes only from an explicit ``backend="jnp"``: on a card it is
    the reference path that chip_smoke.py's small renders hold the kernels
    against, and nothing selects it implicitly.  "auto", the default,
    always resolves to the kernel wrappers."""
    device = torch.device(device)
    if cfg.backend == "auto":
        return "kernels"
    if cfg.backend == "pallas":
        if device.type != "cuda":
            raise ValueError("backend='pallas' selects the CUDA kernels and "
                             f"needs a CUDA device (got {device})")
        return "kernels"
    if cfg.backend == "jnp":
        return "plain"
    raise ValueError(f"unknown backend {cfg.backend!r} (use auto|pallas|jnp)")


def validate_hit_kernel(cfg: RenderConfig) -> None:
    """``hit_kernel`` is "auto", "v4", "v6" or "v7" (the reference's
    get_hit_fn_rows raises on anything else).  All four sweep spheres with
    kernel A here: v4 is its function, exactly, and v6 and v7 differ from
    it only by the split-bf16 limbs this port does not carry.  Where the
    value matters is the route: "auto" and "v7" allow the fused bounce and
    kernel E (persistent.resolve_routes), "v4" and "v6" do not."""
    if cfg.hit_kernel not in ("auto", "v4", "v6", "v7"):
        raise ValueError(f"unknown hit_kernel {cfg.hit_kernel!r} "
                         "(use auto|v4|v6|v7)")


def _hit_fns(cfg: RenderConfig, device):
    """(sphere, brute triangle, grid triangle, sphere grid) rows hit
    functions."""
    validate_hit_kernel(cfg)
    if resolve_backend(cfg, device) == "kernels":
        return (hit_spheres_rows, hit_triangles_rows, hit_triangles_grid_rows,
                hit_spheres_grid_rows)
    return (hit_spheres_rows_plain, hit_triangles_rows_plain,
            hit_triangles_grid_rows_plain, hit_spheres_grid_rows_plain)


def get_hit_fn_rows(cfg: RenderConfig, device, scene=None):
    """Rows-layout hit function for the persistent scheduler, without the
    grid: sphere scenes (and ``scene=None``) get the sphere sweep, triangle
    scenes the brute sweep, composites the brute composite."""
    sphere_fn, tri_fn, _, _ = _hit_fns(cfg, device)
    if scene is None or isinstance(scene, (SphereScene, SphereTable)):
        return sphere_fn
    if isinstance(scene, CompositeScene):
        return _make_composite(sphere_fn, _make_tri_pass(tri_fn))
    return tri_fn


def get_hit_fn(cfg: RenderConfig, device, scene=None):
    """Column hit function ``f(scene, o [N, 3], d [N, 3], t [N], min_t)``
    for the wavefront scheduler (the reference's ``get_hit_fn``): kernel G
    and kernel H under "auto" and "pallas", the plain ``ops`` sweeps under
    "jnp".  Without ``scene`` the sphere sweep; with one, the function for
    its kind (``scene/composite.make_hit_fn``)."""
    if resolve_backend(cfg, device) == "kernels":
        sphere_fn, tri_fn = hit_spheres_cols, hit_triangles_cols
    else:
        sphere_fn, tri_fn = hit_spheres, hit_triangles
    if scene is None:
        return sphere_fn
    return make_hit_fn(scene, sphere_fn, tri_fn)


def hit_tables(scene):
    """What the column hit functions read, built once per render: the
    sphere table, the triangle table, or a composite of those."""
    if isinstance(scene, SphereScene):
        return sphere_table(scene)
    if isinstance(scene, TriangleScene):
        return tri_table(scene)
    if isinstance(scene, CompositeScene):
        return CompositeScene(
            None if scene.spheres is None else sphere_table(scene.spheres),
            None if scene.triangles is None else tri_table(scene.triangles))
    raise TypeError(f"unsupported scene type {type(scene).__name__}")


def validate_tri_knobs(cfg: RenderConfig) -> None:
    """The reference's checks of the triangle knobs (ValueError)."""
    if cfg.tri_rebin not in ("auto", "on", "dda", "off"):
        raise ValueError(
            f"tri_rebin must be auto|on|dda|off, got {cfg.tri_rebin!r}")
    if cfg.tri_any_skip not in ("auto", "on", "off"):
        raise ValueError(
            f"tri_any_skip must be auto|on|off, got {cfg.tri_any_skip!r}")
    if cfg.tri_dda_k < 0:
        raise ValueError(
            f"tri_dda_k must be >= 0 (0 = kernel default), got "
            f"{cfg.tri_dda_k}")
    if cfg.tri_sub_gate not in (0, 1, 2, 4, 8, 16):
        raise ValueError(
            f"tri_sub_gate must be 0 (auto) or a power of two <= 16, "
            f"got {cfg.tri_sub_gate}")
    if cfg.tri_gather not in ("auto", "fused", "deferred"):
        raise ValueError(
            f"tri_gather must be auto|fused|deferred, got "
            f"{cfg.tri_gather!r}")
    if cfg.tri_tile_rows < 0 or cfg.tri_ray_block < 0:
        raise ValueError(
            f"tri_tile_rows and tri_ray_block must be >= 0 (0 = default), "
            f"got {cfg.tri_tile_rows} and {cfg.tri_ray_block}")


def _make_tri_pass(kernel, rebin: str = "off", dda_k: int = 0, **kernel_kw):
    """Triangle pass ``(tris, o, d, t, min_t, t_cap)`` over a hit function
    (the reference's ``_make_tri_pass``).  Without ``kernel_kw``, the
    brute sweep (:func:`_tri_brute_pass`).  The grid sweep (``kernel_kw``:
    its ray block and knobs, and kernel D's ``stats`` counters while a
    render records) runs one of three ways, the same code for kernel D and
    its plain version: directly, on the working set sorted by capped chord
    keys (``rebin="on"``, kernels/tri_rebin.py), or on the DDA pair
    expansion (``"dda"``, kernels/tri_dda.py; ``dda_k`` pairs a lane when
    non-zero).  A missing ``t_cap`` (a mesh with no spheres) is 3.4e38 for
    the last two."""
    if not kernel_kw:
        return _tri_brute_pass(kernel)

    def tf(grid, o, d, t, min_t=MIN_HIT_T, t_cap=None):
        return kernel(grid, o, d, t, min_t=min_t, t_cap=t_cap, **kernel_kw)

    def tri_pass(grid, o, d, t, min_t, t_cap):
        if rebin == "off":
            return tf(grid, o, d, t, min_t=min_t, t_cap=t_cap)
        if t_cap is None:
            t_cap = torch.full_like(o[:1], 3.4e38)
        if rebin == "dda":
            kw = {"k_max": dda_k} if dda_k else {}
            return dda_tri_pass(tf, grid, o, d, t, t_cap, min_t=min_t, **kw)
        return sorted_tri_pass(tf, grid, o, d, t, t_cap, min_t=min_t)
    return tri_pass


def _tri_brute_pass(tri_fn):
    """The brute sweep's triangle pass: ``tri_fn`` (kernel C), which takes
    neither ``t_cap`` nor knobs.  While the render records, each call is
    span ``tri_brute.hit`` and counts its lanes, ``tri_brute.lanes``, a
    shape known on the host (off, both are no-ops)."""
    @functools.wraps(tri_fn)
    def tri_pass(tris, o, d, t, min_t, t_cap):
        profiling.count("tri_brute.lanes", o.shape[1])
        with profiling.span("tri_brute.hit"):
            return tri_fn(tris, o, d, t, min_t=min_t)
    return tri_pass


def _sphere_grid_pass(grid_fn, **kernel_kw):
    """The sphere grid's rows hit function: ``grid_fn`` with ``kernel_kw``
    (kernel I's ``stats`` while a render records).  While the render
    records, each call is span ``sphere_grid.hit`` and counts pass A's
    pair tests, ``sphere_grid.pass_a_tests``: the call's lanes x the
    active globals, both known on the host (off, both are no-ops)."""
    @functools.wraps(grid_fn)
    def grid_pass(gscene, o, d, t, min_t=MIN_HIT_T):
        profiling.count("sphere_grid.pass_a_tests",
                        o.shape[1] * gscene.glob_active)
        with profiling.span("sphere_grid.hit"):
            return grid_fn(gscene, o, d, t, min_t=min_t, **kernel_kw)
    return grid_pass


def _make_composite(sphere_fn, tri_pass, cap: bool = False):
    """Rows hit function over a composite (spheres or None, triangles or
    None).  With ``cap`` the sphere pass's nearest t caps the triangle
    pass."""
    def composite(sc, o, d, t, min_t=0.001):
        if sc.triangles is None:
            return sphere_fn(sc.spheres, o, d, t, min_t=min_t)
        if sc.spheres is None:
            return tri_pass(sc.triangles, o, d, t, min_t, None)
        rec = sphere_fn(sc.spheres, o, d, t, min_t=min_t)
        rec_t = tri_pass(sc.triangles, o, d, t, min_t, rec.t if cap else None)
        return combine_hits_rows(rec, rec_t,
                                 idx_offset_b=sc.spheres.padded_size)
    return composite


def get_hit_fn_rows_accel(cfg: RenderConfig, scene, cam=None):
    """Resolve ``(hit_scene, hit_fn)`` for a scene, the grid applied.

    ``hit_scene`` is what ``hit_fn(hit_scene, o, d, t, min_t)`` reads, built
    once per render: the sphere table of a sphere scene (the
    :class:`GridScene` under ``accel="grid"``), the triangle table of a
    brute mesh, the :class:`TriGridScene` of a gridded one, or a
    :class:`CompositeScene` of those.  With ``accel`` "auto" or "grid" a
    mesh of >= 512 active triangles gets the Morton-tile grid (the brute
    sweep scales with the triangle count); "off" forces the brute sweep.
    ``tri_gather`` "fused" and "deferred" are the same here: the winner is
    always read by index after the sweep.  ``cam`` (the first camera of a
    list) bounds the sphere grid's motion extents by its shutter_close
    (the default camera's when None)."""
    validate_tri_knobs(cfg)
    sphere_fn, tri_fn, grid_fn, sgrid_fn = _hit_fns(cfg, scene.device)
    if isinstance(scene, SphereScene):
        if cfg.accel != "grid":
            return sphere_table(scene), sphere_fn
        time_hi = (SHUTTER_CLOSE_T if cam is None
                   else float(cam.shutter_close))
        gscene = build_grid_accel(scene, time_hi=time_hi)
        if gscene is None:
            raise ValueError(
                "accel='grid' requested but the scene does not qualify "
                "(sphere grids need enough small spheres — "
                "accel.build_grid_accel)")
        kw = {}
        if resolve_backend(cfg, scene.device) == "kernels":
            # While the render records, kernel I adds its CTA tiles and
            # pair tests into one int64 [2] tensor, read at the render's
            # end; None otherwise (the plain version on the CPU adds
            # nothing).
            kw["stats"] = profiling.device_counters(
                {0: "sphere_grid.cta_tiles", 1: "sphere_grid.pair_tests"}, 2,
                scene.device)
        return gscene, _sphere_grid_pass(sgrid_fn, **kw)
    if isinstance(scene, TriangleScene):
        scene = CompositeScene(None, scene)
    if not isinstance(scene, CompositeScene):
        raise TypeError(f"unsupported scene type {type(scene).__name__}")
    if scene.spheres is None and scene.triangles is None:
        raise ValueError("empty composite scene")
    spheres = None if scene.spheres is None else sphere_table(scene.spheres)

    tri = scene.triangles
    grid = None
    if tri is not None and cfg.accel in ("auto", "grid"):
        part = "morton" if cfg.tri_partition == "auto" else cfg.tri_partition
        grid = build_tri_grid(tri, tile_rows=cfg.tri_tile_rows
                              or DEFAULT_TILE_ROWS, partition=part)
    if grid is not None:
        rb = cfg.tri_ray_block or DEFAULT_TRI_GRID_RAY_BLOCK
        # tri_sub_gate only sets how finely the reference's any-touch gate
        # skips work, per ray_block / q lanes; kernel D votes per CTA of 32
        # lanes and runs unchanged.  Kept: the reference kernel's refusal of
        # a split that is not a multiple of 128 lanes, where its Pallas
        # route raises it (the skip on; "auto" picks 2 only where it fits).
        q = cfg.tri_sub_gate
        if (q > 1 and cfg.tri_any_skip in ("auto", "on") and rb % (128 * q)
                and resolve_backend(cfg, scene.device) == "kernels"):
            raise ValueError(f"n_sub={q} must divide ray_block={rb} into "
                             f"128-lane multiples")
        kw = {}
        if resolve_backend(cfg, scene.device) == "kernels":
            # While the render records, kernel D adds its pair tests and
            # any-touch tests into one int64 [4] tensor, read at the
            # render's end; None otherwise (the plain version on the CPU
            # adds nothing).
            kw["stats"] = profiling.device_counters(
                {1: "tri_grid.pair_tests", 2: "tri_grid.touch_tests"}, 4,
                scene.device)
        tri_pass = _make_tri_pass(
            grid_fn, rebin="off" if cfg.tri_rebin == "auto" else cfg.tri_rebin,
            dda_k=cfg.tri_dda_k, ray_block=rb,
            early_exit=cfg.tri_early_exit in ("auto", "on"),
            any_skip=cfg.tri_any_skip in ("auto", "on"), **kw)
        hit_scene, cap = CompositeScene(spheres, grid), True
    elif cfg.accel == "grid":
        raise ValueError(
            "accel='grid' requested but the scene does not qualify (triangle "
            "grids need a mesh with enough triangles — "
            "tri_accel.build_tri_grid)")
    else:
        tri_pass = _make_tri_pass(tri_fn)
        hit_scene = CompositeScene(spheres, None if tri is None
                                   else tri_table(tri))
        cap = False
    if spheres is None:
        def tri_only(tris, o, d, t, min_t=0.001):
            return tri_pass(tris, o, d, t, min_t, None)
        return hit_scene.triangles, tri_only
    return hit_scene, _make_composite(sphere_fn, tri_pass, cap=cap)
