"""PyTorch port: the packed sphere sweep of kernels A, B, E and G, in torch.

Kernels A, B, E and G (csrc/common.cuh ``sweep_packed``) visit the spheres in
another order than ops/hit.py ``_sweep``: each block stages the active rows
of a tile ascending, packed as {c1, r*r}, {dc, 0} and {t1, invdt}, with
their original rows; where every staged row shares its (t1, invdt) bits the lerp is
formed once per ray and tile; each chunk of 32 staged spheres is swept
twice, once for the bits disc >= 0 and once for the roots of the set bits,
ascending.  This file writes that order in torch
and holds it against ``_sweep`` bit for bit, on scenes with padding and
inactive rows, on rays with constructed exact ties between two spheres and
on rays that graze the r=1000 ground.  Kernels A, E and G sweep R = 1 or 2
rays a thread (ray i0 + r * 256 of a block of 256 R); kernel G reads [N, 3]
rays and writes a column record; kernel E sweeps every lane, dead ones
too, then adds the sky for the live lanes that miss: those forms are
written here too and held to ops/hit.py ``hit_spheres`` and
kernels/hit_sky.py ``hit_sky_plain`` bit for bit.  The CUDA kernels
themselves are held against the plain versions on the card (chip_smoke.py
phases 2, 3, 5, 9 and 13)."""

import numpy as np
import pytest
import torch

from win32_raytracer_tpu_torch.core.vec import sqrt_rn
from win32_raytracer_tpu_torch.config import RenderConfig
from win32_raytracer_tpu_torch.kernels import hit as K
from win32_raytracer_tpu_torch.kernels import hit_cols as G
from win32_raytracer_tpu_torch.kernels import hit_sky as E
from win32_raytracer_tpu_torch.kernels.hit import rays_per_thread
from win32_raytracer_tpu_torch.persistent import PathState
from win32_raytracer_tpu_torch.ops.hit import (
    ATTR_COLS, F32_MAX, SphereTable, _sweep, hit_spheres, sphere_table)
from win32_raytracer_tpu_torch.scene.builders import get_scene, random_scene

torch.set_num_threads(1)

TILE = 256                   # csrc/common.cuh kBlock: rows per staged tile
CHUNK = 32                   # spheres per mask pass (sweep_packed_tile)
C1, DC, T1, INVDT, RADIUS, IDX = slice(0, 3), slice(3, 6), 6, 7, 8, 15


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def stage_packed(tab: SphereTable, row0: int, rows: int):
    """csrc/common.cuh stage_packed: the active rows among
    [row0, row0 + rows), ascending -> ({c1, r*r} [K, 4], dc [K, 3],
    original rows [K], {t1, invdt} [K, 2], uniform)."""
    rows_idx = torch.nonzero(tab.active[row0:row0 + rows]).flatten() + row0
    g = tab.attrs[rows_idx]
    r = g[:, RADIUS]
    cr = torch.cat([g[:, C1], (r * r)[:, None]], dim=1)
    tv = g[:, T1:INVDT + 1]
    uniform = bool(len(rows_idx)) and bool((_bits(tv) == _bits(tv[:1])).all())
    return cr, g[:, DC], rows_idx, tv, uniform


def _disc(cr, dc, lj, ox, oy, oz, dx, dy, dz, a, j):
    """b and disc of every ray against staged sphere j (packed_disc)."""
    cx = cr[j, 0] + dc[j, 0] * lj
    cy = cr[j, 1] + dc[j, 1] * lj
    cz = cr[j, 2] + dc[j, 2] * lj
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = dx * ocx + dy * ocy + dz * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - cr[j, 3]
    return b, b * b - a * c


def sweep_packed(tab: SphereTable, o, d, t, min_t):
    """csrc/common.cuh sweep_packed for rays o/d [n, 3], t [n]: tile by
    tile, in chunks of CHUNK staged spheres; a chunk's first pass keeps
    only the bits disc >= 0, its second visits the set bits ascending and
    forms those roots from b and disc recomputed, strict < -> (best t,
    original row, -1 where no hit)."""
    s = tab.attrs.shape[0]
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    a = dx * dx + dy * dy + dz * dz
    ray = (ox, oy, oz, dx, dy, dz, a)
    best_t = torch.full_like(ox, F32_MAX)
    best_i = torch.full(ox.shape, -1, dtype=torch.int64)
    for base in range(0, s, TILE):
        cr, dc, rows, tv, uniform = stage_packed(tab, base, min(TILE, s - base))

        def lerp(j):
            return ((t - tv[0, 0]) * tv[0, 1] if uniform
                    else (t - tv[j, 0]) * tv[j, 1])
        for j0 in range(0, len(rows), CHUNK):
            chunk = range(j0, min(j0 + CHUNK, len(rows)))
            bits = torch.stack([_disc(cr, dc, lerp(j), *ray, j)[1] >= 0.0
                                for j in chunk])
            for k, j in enumerate(chunk):
                b, disc = _disc(cr, dc, lerp(j), *ray, j)
                root = (-b - sqrt_rn(torch.clamp_min(disc, 0.0))) / a
                win = bits[k] & (root > min_t) & (root < best_t)
                best_t = torch.where(win, root, best_t)
                best_i = torch.where(win, rows[j], best_i)
    return best_t, best_i


# ---------------------------------------------------------------- inputs --

def _table(kind: str) -> SphereTable:
    """The final scene's table (488 spheres padded to 512); "holes": every
    seventh sphere inactive besides the padding; "ties": rows 300-339 copy
    the geometry of rows 4-43 and rows 470-479 that of rows 40-49, each
    keeping its own index and albedo (the later row must lose every exact
    tie, also across tiles); "moving": ties with every fifth
    row's shutter interval moved, so no tile has one (t1, invdt)."""
    tab = sphere_table(get_scene("final"))
    attrs, active = tab.attrs.clone(), tab.active.clone()
    if kind == "holes":
        active[4:488:7] = False
    if kind == "moving":
        attrs[::5, T1] = 0.25
        attrs[::5, INVDT] = 1.0 / (1.0 - attrs[::5, T1])
    if kind in ("ties", "moving"):
        for dst, src in ((range(300, 340), range(4, 44)), (range(470, 480), range(40, 50))):
            attrs[list(dst), :RADIUS + 1] = attrs[list(src), :RADIUS + 1]
    return SphereTable(attrs, active)


def _rays(tab: SphereTable, n: int, seed: int):
    """A quarter each: rays aimed at tied spheres (rows 4-49), rays from
    the camera region, rays from inside the glass spheres, and rays that
    graze the r=1000 ground (from just above it, a few degrees downward)."""
    rng = np.random.default_rng(seed)
    g = tab.attrs.numpy()
    q = n // 4
    o = rng.uniform([-12, 0.01, -12], [12, 4, 12], (n, 3))
    d = rng.normal(0, 1, (n, 3))
    tgt = g[rng.integers(4, 50, q), :3]
    d[:q] = tgt - o[:q] + rng.normal(0, 0.02, (q, 3))
    o[q:2 * q] = [13.0, 2.0, 3.0] + rng.normal(0, 0.3, (q, 3))
    glass = np.flatnonzero((g[:, 9] == 2) & tab.active.numpy())
    o[2 * q:3 * q] = g[rng.choice(glass, q), :3] + rng.normal(0, 0.05, (q, 3))
    m = n - 3 * q
    o[3 * q:] = np.c_[rng.uniform(-20, 20, m), rng.uniform(1e-3, 0.05, m),
                      rng.uniform(-20, 20, m)]
    d[3 * q:] = np.c_[rng.normal(0, 1, m), -rng.uniform(2e-3, 0.05, m),
                      rng.normal(0, 1, m)]
    t = rng.uniform(0, 0.05, n)
    return tuple(torch.as_tensor(x, dtype=torch.float32) for x in (o, d, t))


KINDS = ("final", "holes", "ties", "moving")


# ----------------------------------------------------------------- tests --

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("row0", [0, 256, 300])
def test_staged_table_is_the_active_rows(kind, row0):
    """The staged tile holds exactly the tile's active rows, ascending, with
    their original rows, their geometry bit for bit, and r*r as _sweep
    forms it; padding and inactive rows never appear."""
    tab = _table(kind)
    scene = get_scene("final")
    cr, dc, rows, tv, uniform = stage_packed(tab, row0, TILE)
    act = tab.active.numpy()
    want = [r for r in range(row0, min(row0 + TILE, len(act))) if act[r]]
    assert rows.tolist() == want and len(want) > 0
    assert int(rows.max()) < int(scene.active.sum())   # no padding row
    g = tab.attrs[rows]
    assert torch.equal(_bits(cr[:, :3]), _bits(g[:, C1]))
    assert torch.equal(_bits(cr[:, 3]), _bits(g[:, RADIUS] * g[:, RADIUS]))
    assert torch.equal(_bits(dc), _bits(g[:, DC]))
    assert torch.equal(_bits(tv), _bits(g[:, T1:INVDT + 1]))
    assert uniform == (kind != "moving")
    if kind in ("final", "holes"):
        # The scene's own columns: center1 and center2 - center1, one radius.
        torch.testing.assert_close(dc, (scene.center2 - scene.center1)[rows],
                                   rtol=0, atol=0)
        assert torch.equal(g[:, IDX].long(), rows)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("min_t", [0.001, 0.0])
def test_packed_order_equals_sweep(kind, min_t):
    """Staged order, packed r*r and the shared lerp change no bit of t and
    no winner of ops/hit.py _sweep."""
    tab = _table(kind)
    o, d, t = _rays(tab, 2048, seed=len(kind))
    want_t, want_i = _sweep(tab, o, d, t, min_t, 128)
    got_t, got_i = sweep_packed(tab, o, d, t, min_t)
    assert torch.equal(_bits(got_t), _bits(want_t))
    assert torch.equal(got_i, want_i)
    hit = want_i >= 0
    assert 0.3 < float(hit.float().mean()) < 0.98
    if kind in ("ties", "moving"):
        # Rays that hit a tied sphere: the lower row of the pair wins.
        assert ((want_i >= 4) & (want_i < 50)).sum() > 50
        assert not ((want_i >= 300) & (want_i < 340)).any()
        assert not ((want_i >= 470) & (want_i < 480)).any()


def test_grazing_rays_meet_the_ground():
    """The grazing quarter of the rays does reach the ground sphere (row 0),
    where the root cancels worst, and the packed order keeps its t."""
    tab = _table("final")
    o, d, t = _rays(tab, 2048, seed=5)
    g = slice(3 * 512, 2048)
    want_t, want_i = _sweep(tab, o[g], d[g], t[g], 0.001, 128)
    got_t, got_i = sweep_packed(tab, o[g], d[g], t[g], 0.001)
    assert (want_i == 0).sum() > 100
    assert torch.equal(_bits(got_t), _bits(want_t)) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("min_t", [0.001, 0.0])
def test_packed_order_equals_sweep_on_random_scenes(seed, min_t):
    """The same on random_scene's own layouts (other radii, materials and
    active counts), with the rays aimed at its spheres."""
    tab = sphere_table(random_scene(seed=seed))
    g = tab.attrs[tab.active]
    rng = np.random.default_rng(seed)
    n = 1024
    o = rng.uniform([-12, 0.01, -12], [12, 4, 12], (n, 3))
    d = g[torch.as_tensor(rng.integers(0, len(g), n)), :3].numpy() - o
    d[: n // 2] = rng.normal(0, 1, (n // 2, 3))
    o, d = (torch.as_tensor(x, dtype=torch.float32) for x in (o, d))
    t = torch.as_tensor(rng.uniform(0, 0.05, n), dtype=torch.float32)
    want_t, want_i = _sweep(tab, o, d, t, min_t, 128)
    got_t, got_i = sweep_packed(tab, o, d, t, min_t)
    assert torch.equal(_bits(got_t), _bits(want_t))
    assert torch.equal(got_i, want_i)
    assert float((want_i >= 0).float().mean()) > 0.4


@pytest.mark.parametrize("n, sms, want", [
    (1 << 19, 132, 2),        # the floor's batch: 1,024 blocks of 512 rays
    (1 << 18, 132, 2),        # the headline's tail: 512 blocks
    (67584, 132, 2),          # 132 blocks of 512 rays: one per SM
    (67073, 132, 2),          # the 132nd block holds one ray
    (67072, 132, 1),          # 131 blocks: one ray per thread
    (1 << 16, 132, 1),        # 128 blocks of 512 would idle 4 SMs
    (1 << 15, 132, 1),        # the headline's smallest tail batch
    (1 << 12, 132, 1),        # the scheduler's smallest batch
    (1 << 16, 114, 2),        # a card with fewer SMs
])
def test_rays_per_thread(n, sms, want):
    assert rays_per_thread(n, sms) == want


def test_wrapper_validates_its_launch_arguments():
    """The launch form must be 1 or 2 rays per thread on every device; on
    the CPU the wrapper is the plain sweep whatever the form, and counts
    no launch."""
    tab = sphere_table(get_scene("final"))
    o, d, t = _rays(tab, 64, seed=3)
    o, d, t = o.T.contiguous(), d.T.contiguous(), t[None].contiguous()
    with pytest.raises(ValueError, match="1 or 2"):
        K.hit_spheres_rows(tab, o, d, t, _rays=4)
    before = K.LAUNCHES
    plain = K.hit_spheres_rows_plain(tab, o, d, t)
    for kw in ({}, dict(_rays=1), dict(_rays=2)):
        rec = K.hit_spheres_rows(tab, o, d, t, **kw)
        assert all(torch.equal(x, y) for x, y in zip(rec, plain))
    assert K.LAUNCHES == before


def test_attr_columns_are_the_kernel_layout():
    """The column numbers this file and csrc/common.cuh AttrCol use."""
    assert ATTR_COLS == 16
    tab = sphere_table(random_scene())
    assert torch.equal(tab.attrs[:, IDX].long(), torch.arange(tab.attrs.shape[0]))


# ------------------------------------------- kernels G and E, R rays a thread --

BLOCK = 256                  # csrc/common.cuh kBlock: threads per block
T1_, INVDT_, C1X, MAT, ALB, FUZZ, IOR = 6, 7, 0, 9, slice(10, 13), 13, 14


def thread_order(n: int, rays: int) -> torch.Tensor:
    """The rays in the order the threads of csrc/common.cuh sphere_hit_body
    (and hit_sky_kernel) hold them: thread k of block b sweeps rays
    b * 256 R + r * 256 + k, r < R; rays past n are dropped."""
    nb = -(-n // (BLOCK * rays))
    i = (torch.arange(nb)[:, None, None] * (BLOCK * rays)
         + torch.arange(rays)[None, :, None] * BLOCK
         + torch.arange(BLOCK)[None, None, :])
    i = i.permute(0, 2, 1).reshape(-1)       # thread-major: a thread's R rays
    return i[i < n]


def winner_record(tab: SphereTable, best_t, best_i, o, d, t):
    """csrc/common.cuh winner_record for rays o/d [n, 3], t [n]: the
    winner's row read by index (zeros on a miss), the point, the normal
    from the centre at t."""
    hit = best_i >= 0
    g = torch.where(hit[:, None], tab.attrs[best_i.clamp_min(0)], 0.0)
    ts = torch.where(hit, best_t, 0.0)
    p = o + ts[:, None] * d
    lerp = (t - g[:, T1_]) * g[:, INVDT_]
    c = g[:, C1X:C1X + 3] + g[:, DC] * lerp[:, None]
    denom = torch.where(g[:, RADIUS] == 0.0, 1.0, g[:, RADIUS])
    return dict(hit=hit, t=best_t, point=p, normal=(p - c) / denom[:, None],
                idx=g[:, IDX].to(torch.int32), mat_id=g[:, MAT].to(torch.int32),
                albedo=g[:, ALB], fuzz=g[:, FUZZ], ior=g[:, IOR])


def kernel_g(tab: SphereTable, o, d, t, min_t, rays):
    """Kernel G in torch: the rays taken in thread order, swept by the
    packed order, the record stored at each ray's own index (the column
    record's fields)."""
    order = thread_order(o.shape[0], rays)
    bt, bi = sweep_packed(tab, o[order], d[order], t[order], min_t)
    rec = winner_record(tab, bt, bi, o[order], d[order], t[order])
    out = {}
    for k, v in rec.items():
        out[k] = torch.empty_like(v)
        out[k][order] = v
    return out


def kernel_e(tab: SphereTable, st: PathState, min_t, rays):
    """Kernel E in torch: every lane swept (dead ones too) in thread order,
    its record in rows, then csrc/common.cuh hit_sky: a live lane that
    misses adds throughput * the sky gradient; alive &= hit."""
    o, d, t = st.origin.T, st.direction.T, st.time[0]
    rec = kernel_g(tab, o, d, t, min_t, rays)
    alive = st.path_alive[0]
    miss = alive & ~rec["hit"]
    ln = sqrt_rn(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    s = 0.5 * (d[:, 1] / torch.clamp_min(ln, 1e-37) + 1.0)
    tint = torch.tensor([0.5, 0.7, 1.0])
    sky = (1.0 - s)[:, None] + s[:, None] * tint
    rad = st.radiance_sum.T + torch.where(miss[:, None], st.throughput.T * sky, 0.0)
    return rec, rad.T, (alive & rec["hit"])[None]


def _scene_table(kind: str) -> SphereTable:
    if kind.startswith("random"):
        return sphere_table(random_scene(seed=int(kind[6:])))
    return _table(kind)


def _aimed_rays(tab: SphereTable, n: int, seed: int):
    """_rays for the built-in tables; for a random scene, half the rays
    aimed at its active spheres."""
    if tab.attrs.shape[0] == 512 and bool(tab.active[:488].all()):
        return _rays(tab, n, seed)
    rng = np.random.default_rng(seed)
    g = tab.attrs[tab.active]
    o = rng.uniform([-12, 0.01, -12], [12, 4, 12], (n, 3))
    d = g[torch.as_tensor(rng.integers(0, len(g), n)), :3].numpy() - o
    d[: n // 2] = rng.normal(0, 1, (n // 2, 3))
    t = rng.uniform(0, 0.05, n)
    return tuple(torch.as_tensor(x, dtype=torch.float32) for x in (o, d, t))


SCENES = ("final", "ties", "moving", "random0", "random3")


@pytest.mark.parametrize("kind", SCENES)
@pytest.mark.parametrize("rays", [1, 2])
def test_kernel_g_order_equals_hit_spheres(kind, rays):
    """Kernel G's form: column rays [N, 3] (N not a multiple of a block),
    R rays a thread, the packed order, the record by index, equal to
    ops/hit.py hit_spheres bit for bit; the lower row keeps exact ties."""
    tab = _scene_table(kind)
    n = 1000
    o, d, t = _aimed_rays(tab, n, seed=rays + len(kind))
    got = kernel_g(tab, o, d, t, 0.001, rays)
    want = hit_spheres(tab, o, d, t)
    for f in want._fields:
        w, g = getattr(want, f), got[f]
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w), f
    assert 0.3 < float(want.hit.float().mean()) < 0.99
    if kind == "ties":
        assert not ((want.idx >= 300) & (want.idx < 340)).any()


def _dead_state(tab: SphereTable, n: int, seed: int) -> PathState:
    """A rows-layout path state over ``_aimed_rays``: about a third of the
    lanes dead, spread through every block."""
    o, d, t = _aimed_rays(tab, n, seed)
    rng = np.random.default_rng(seed + 1)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)
    i32 = dict(dtype=torch.int32)
    return PathState(
        origin=o.T.contiguous(), direction=d.T.contiguous(), time=t[None],
        throughput=f32(rng.uniform(0, 1, (3, n))),
        radiance_sum=f32(rng.uniform(0, 1, (3, n))),
        depth=torch.ones((1, n), **i32), sample=torch.zeros((1, n), **i32),
        pixel=torch.arange(n, **i32)[None],
        path_alive=torch.as_tensor(rng.uniform(size=(1, n)) < 0.67),
        s_base=torch.zeros((1, n), **i32), s_quota=torch.ones((1, n), **i32))


@pytest.mark.parametrize("kind", ("final", "holes", "ties", "random1"))
@pytest.mark.parametrize("rays", [1, 2])
def test_kernel_e_sweeps_dead_lanes_too(kind, rays):
    """Kernel E's form: every lane swept, dead lanes mixed in, R lanes a
    thread, the record in rows, then the sky on the live misses: equal to
    hit_sky_plain bit for bit, the record of the dead lanes included, and
    a dead lane's radiance and alive flag passed through."""
    tab = _scene_table(kind)
    n = 1300
    st = _dead_state(tab, n, seed=7 * rays + len(kind))
    cfg = RenderConfig(width=40, height=33, samples=1)
    rec, rad, alive = kernel_e(tab, st, cfg.min_hit_t, rays)
    want, wst = E.hit_sky_plain(tab, st, cfg=cfg)
    for f in want._fields:
        w, g = getattr(want, f), rec[f]
        g = g[None] if w.shape[0] == 1 else g.T
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w), f
    assert torch.equal(_bits(rad), _bits(wst.radiance_sum))
    assert torch.equal(alive, wst.path_alive)
    dead = ~st.path_alive[0]
    assert dead.sum() > n // 4 and (want.hit[0] & dead).sum() > 50
    assert torch.equal(_bits(rad[:, dead]), _bits(st.radiance_sum[:, dead]))
    assert not alive[0, dead].any()
    live_miss = st.path_alive[0] & ~want.hit[0]
    assert live_miss.sum() > 20


@pytest.mark.parametrize("who, call", [
    ("hit_sky", lambda tab, o, d, t, r: E.hit_sky(
        tab, _dead_state(tab, 64, 1), cfg=RenderConfig(), _rays=r)),
    ("hit_spheres_cols", lambda tab, o, d, t, r: G.hit_spheres_cols(
        tab, o, d, t, _rays=r))])
def test_e_and_g_wrappers_validate_their_launch_form(who, call):
    """As kernel A's wrapper: the forced form must be 1 or 2 on every
    device; on the CPU any valid form is the plain version and counts no
    launch."""
    tab = sphere_table(get_scene("final"))
    o, d, t = _rays(tab, 64, seed=3)
    with pytest.raises(ValueError, match=f"{who}: _rays must be 1 or 2"):
        call(tab, o, d, t, 3)
    before = (E.LAUNCHES, G.LAUNCHES)

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x.reshape(-1).float()]
        return [y for part in x for y in flat(part)]
    outs = [torch.cat(flat(call(tab, o, d, t, r))) for r in (None, 1, 2)]
    assert all(torch.equal(outs[0], x) for x in outs[1:])
    assert (E.LAUNCHES, G.LAUNCHES) == before
