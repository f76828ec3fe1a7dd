"""PyTorch port: what the grid kernels' schedule and sweep do, in torch.

Kernels D and I run as two launches each: a schedule kernel that builds on
the card what was a torch prelude, then the sweep.  Their CUDA code cannot
run here, so this file writes the orders and reductions they use in torch
and holds them against the unchanged plain code, exactly:

* kernel D's schedule kernel (csrc/tri_grid.cu tri_grid_schedule_kernel):
  filler rays made in the kernel, the block extremes folded per thread,
  per warp and across warps with torch.minimum / torch.maximum semantics,
  the stable order by (key, tile id) by rank counting, the count and the
  bounds floored onto the 1/1024 grid, against kernels/tri_grid
  .schedule_plain (tri_block_schedule_rows, block_schedule);
* kernel I's schedule kernel (csrc/hit_grid.cu hit_grid_schedule_kernel):
  the footprint folded in the same order and the tile ids written by a
  ballot and prefix sum, against accel.footprint_block_mask and
  accel.block_schedule;
* kernel I's sweep: the scheduled tiles' rows with r != 0 staged
  ascending, 256 candidate rows a stage, each stage swept as
  csrc/common.cuh sweep_packed_tile sweeps it (the mask of disc >= 0 per
  32 rows, then the roots, strict <), against accel._sweep_tiles bit for
  bit.

The kernels themselves are held to the same plain code on the card
(chip_smoke.py phases 7 and 15)."""

import numpy as np
import pytest
import torch

from win32_raytracer_tpu_torch import accel as A
from win32_raytracer_tpu_torch import tri_accel as TA
from win32_raytracer_tpu_torch.core.vec import sqrt_rn
from win32_raytracer_tpu_torch.kernels import hit_grid as KI
from win32_raytracer_tpu_torch.kernels import tri_grid as KD
from win32_raytracer_tpu_torch.ops.hit import F32_MAX, SphereTable, _sweep
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.scene import triangles as ttri

torch.set_num_threads(1)

THREADS = 256      # kernel threads per CTA (kThreads)
STAGE = 256        # candidate rows per stage (kBlock)
CHUNK = 32         # rows per mask pass
BIG = float(np.float32(1e8))
EPS = float(np.float32(1e-12))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def tmin(a, b):
    """csrc/common.cuh tmin: a if a < b or a is NaN, else b."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.where((a < b) | (a != a), a, b)


def tmax(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.where((a > b) | (a != a), a, b)


def cta_fold(x: torch.Tensor, op, init: float, threads: int = THREADS):
    """A block reduction in the kernels' order: x [NB, ray_block] folded
    per thread over its strided lanes, then per warp by xor shuffles, then
    over the warps in order -> [NB]."""
    nb, rb = x.shape
    per = -(-rb // threads)
    pad = torch.full((nb, per * threads - rb), init, dtype=x.dtype)
    v = torch.cat([x, pad], dim=1).reshape(nb, per, threads)
    acc = torch.full((nb, threads), init, dtype=x.dtype)
    for k in range(per):
        acc = op(acc, v[:, k])
    lanes = torch.arange(threads)
    for s in (16, 8, 4, 2, 1):
        acc = op(acc, acc[:, lanes ^ s])
    out = acc[:, 0]
    for w in range(threads // 32):
        out = op(out, acc[:, 32 * w])
    return out


# ------------------------------------------------------------- kernel D --

def _tri_grid(tile_rows=128, partition="morton"):
    """tests/test_torch_tri_hit.py's 1,292-triangle mesh (an icosphere and
    a box) on a Morton-tile grid."""
    v1, f1 = ttri.icosphere_mesh((0.0, 1.0, 0.0), 1.0, subdivisions=3)
    v2, f2 = ttri.box_mesh((2.0, 0.4, 0.5), (0.8, 0.8, 0.8))
    scene = ttri.build_triangle_scene(np.concatenate([v1, v2]),
                                      np.concatenate([f1, f2 + len(v1)]))
    return TA.build_tri_grid(scene, tile_rows=tile_rows, partition=partition)


def _tied(grid):
    """The grid with tile boxes copied onto others (tiles 3 and 5 take
    tile 1's box, tile 6 tile 0's), so their entry bounds tie exactly and
    the stable order must keep tile-id order among them."""
    boxes = grid.tile_boxes.clone()
    boxes[3] = boxes[1]
    boxes[5] = boxes[1]
    boxes[6] = boxes[0]
    return TA.make_tri_grid(grid.base, grid.tile_attrs, boxes, grid.scene_box)


def _tri_rays(n, block, seed, away_blocks=()):
    """Rays [3, N] in coherent blocks of ``block`` (sparse block masks);
    the blocks listed in ``away_blocks`` point away from the scene box, so
    every segment there is empty, and the last of them is filler rays as
    tri_accel.pad_rays makes them."""
    rng = np.random.default_rng(seed)
    nb = -(-n // block)
    oc = rng.uniform([-4.0, 0.0, -4.0], [4.0, 3.0, 4.0], (nb, 3))
    tgt = [0.5, 0.8, 0.2] + rng.normal(0, 1.0, (nb, 3))
    o = np.repeat(oc, block, 0)[:n] + rng.normal(0, 0.05, (n, 3))
    d = np.repeat(tgt - oc, block, 0)[:n] + rng.normal(0, 0.1, (n, 3))
    for k, b in enumerate(away_blocks):
        sl = slice(b * block, min((b + 1) * block, n))
        o[sl] = [0.0, 20.0, 0.0]
        d[sl] = [0.0, 1.0, 0.0]
        if k == len(away_blocks) - 1:
            o[sl] = [0.0, -1e9, 0.0]
            d[sl] = [0.0, 0.0, 1.0]
    return (torch.as_tensor(o.T.copy(), dtype=torch.float32),
            torch.as_tensor(d.T.copy(), dtype=torch.float32))


def tri_schedule_model(grid, origin, direction, t_cap, min_t, rb):
    """tri_grid_schedule_kernel in torch: (sched, bounds, cap_eff [N])."""
    n = origin.shape[1]
    nb = -(-n // rb)
    np_ = nb * rb
    # Filler lanes made in the kernel: o = (0, -1e9, 0), d = (0, 0, 1),
    # t_cap 0.
    o = torch.zeros((3, np_))
    o[1] = -1e9
    d = torch.zeros((3, np_))
    d[2] = 1.0
    o[:, :n], d[:, :n] = origin, direction
    f32 = torch.float32
    lo_t = torch.full((np_,), float(np.float32(min_t)), dtype=f32)
    hi_t = torch.full((np_,), BIG, dtype=f32)
    if t_cap is not None:
        cap = torch.zeros(np_)
        cap[:n] = t_cap[0]
        hi_t = tmin(hi_t, cap)
    sb = grid.scene_box
    for ax in range(3):
        ds = torch.where(d[ax].abs() < EPS, torch.where(d[ax] < 0, -EPS, EPS), d[ax])
        ta = (sb[2 * ax] - o[ax]) / ds
        tb = (sb[2 * ax + 1] - o[ax]) / ds
        lo_t = tmax(lo_t, tmin(ta, tb))
        hi_t = tmin(hi_t, tmax(ta, tb))
    empty = lo_t > hi_t
    cap_eff = torch.where(empty, 0.0, hi_t)[:n]

    def fold(x, fill, op, init):
        return cta_fold(torch.where(empty, fill, x).reshape(nb, rb), op, init)

    inf = float("inf")
    seg_lo, seg_hi, o_lo, o_hi = [], [], [], []
    for ax in range(3):
        pa, pb = o[ax] + lo_t * d[ax], o[ax] + hi_t * d[ax]
        seg_lo.append(fold(tmin(pa, pb), BIG, tmin, inf))
        seg_hi.append(fold(tmax(pa, pb), -BIG, tmax, -inf))
        o_lo.append(fold(o[ax], BIG, tmin, inf))
        o_hi.append(fold(o[ax], -BIG, tmax, -inf))
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    dmax = sqrt_rn(fold(d2, 0.0, tmax, -inf))

    bx = grid.tile_boxes
    ov = torch.ones((nb, grid.n_tiles), dtype=torch.bool)
    dist2 = torch.zeros((nb, grid.n_tiles))
    for ax in range(3):
        ov &= (seg_lo[ax][:, None] <= bx[None, :, 2 * ax + 1]) & (
            seg_hi[ax][:, None] >= bx[None, :, 2 * ax])
        gap = tmax(tmax(bx[None, :, 2 * ax] - o_hi[ax][:, None],
                        o_lo[ax][:, None] - bx[None, :, 2 * ax + 1]), 0.0)
        dist2 = dist2 + gap * gap
    tlo = tmax(sqrt_rn(dist2) / tmax(dmax, EPS)[:, None], float(np.float32(min_t)))
    key = torch.where(ov, tmin(tlo, float(KD._TLO_CAP)), float(KD._TLO_PAD))

    # Rank counting: (key, id) in torch's sort order, NaN last.
    t = grid.n_tiles
    ids = torch.arange(t)
    ku, kt = key[:, None, :], key[:, :, None]
    less = (ku < kt) | ((ku == ku) & (kt != kt))
    equal = (ku == kt) | ((ku != ku) & (kt != kt))
    rank = (less | (equal & (ids[None, None, :] < ids[None, :, None]))).sum(2)
    sched = torch.empty((nb, t + 1), dtype=torch.int32)
    bounds = torch.empty((nb, t + 1), dtype=torch.float32)
    sched[:, 0] = ov.sum(1, dtype=torch.int32)
    rows = torch.arange(nb)[:, None].expand(nb, t)
    sched[rows, 1 + rank] = ids.to(torch.int32).expand(nb, t)

    def quant(k):
        return torch.floor(k * float(KD._TLO_SCALE)).to(torch.int32).to(f32) * float(KD._TLO_INV)
    bounds[rows, rank] = quant(key)
    bounds[:, t] = quant(torch.tensor(float(KD._TLO_PAD)))
    return sched, bounds, cap_eff


D_CASES = {
    # (tile rows, partition, tied boxes, ray_block, rays, away blocks, cap)
    "default": (128, "morton", False, 256, 4096, (), False),
    "t_cap": (128, "morton", False, 256, 4096, (), True),
    "ties": (128, "morton", True, 256, 4096, (), True),
    "empty blocks": (128, "morton", False, 256, 4096, (3, 7, 15), False),
    "ray_block 1000": (128, "morton", False, 1000, 3500, (), True),
    "tile_rows 200": (200, "median", True, 1000, 3500, (0, 3), True),
}


@pytest.mark.parametrize("rows, part, tied", [(128, "morton", False),
                                              (200, "median", True)])
def test_tri_grid_carries_kernel_d_tables(rows, part, tied):
    """Kernel D's per-grid tables are made with the grid: the packed
    geometry (v0, e1, e2 and three zeros a row) and the tile boxes on the
    1/1024 grid, widened, follow the grid's own arrays, also through
    ``to`` and for a grid made from other boxes."""
    grid = _tri_grid(rows, part)
    if tied:
        grid = _tied(grid)
    geom = grid.tile_geom
    assert geom.shape == (grid.n_tiles * grid.tile_rows, 12)
    assert torch.equal(geom[:, :9], grid.tile_attrs[:, :9])
    assert (geom[:, 9:] == 0.0).all()
    q = grid.tile_qboxes
    assert torch.equal(q, TA.quantized_boxes(grid.tile_boxes))
    assert (q[:, 0::2] < grid.tile_boxes[:, 0::2]).all()
    assert (q[:, 1::2] > grid.tile_boxes[:, 1::2]).all()
    assert torch.equal(_bits(q * 1024.0), _bits(torch.round(q * 1024.0)))
    moved = grid.to("cpu")
    assert torch.equal(moved.tile_geom, geom) and torch.equal(moved.tile_qboxes, q)


@pytest.mark.parametrize("case", sorted(D_CASES))
def test_tri_schedule_kernel_order_equals_block_schedule(case):
    """The schedule kernel's sched, bounds and segment ends are
    integer-equal to the torch prelude's (rank counting against the stable
    argsort, ties of key included)."""
    rows, part, tied, rb, n, away, with_cap = D_CASES[case]
    grid = _tri_grid(rows, part)
    if tied:
        grid = _tied(grid)
    o, d = _tri_rays(n, rb, seed=rows + n, away_blocks=away)
    cap = None
    if with_cap:
        cap = torch.as_tensor(np.random.default_rng(n).uniform(1.0, 8.0, (1, n)),
                              dtype=torch.float32)
    got = tri_schedule_model(grid, o, d, cap, 0.001, rb)
    want = KD.schedule_plain(grid, o, d, cap, 0.001, rb)
    assert torch.equal(got[0], want[0])
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert torch.equal(_bits(got[2]), _bits(want[2][0, :n]))
    count = want[0][:, 0]
    assert 0 < int(count.sum()) < count.numel() * grid.n_tiles
    if away:
        assert (count[list(away)] == 0).all()
        assert (want[1][list(away), :] == float(KD._TLO_PAD)).all()
    if tied:
        # Tiles 1, 3 and 5 share one box, so one key in every block: where
        # they are scheduled they keep tile-id order.
        order = want[0][:, 1:]
        pos = torch.stack([(order == k).int().argmax(1) for k in (1, 3, 5)], 1)
        sched_all = pos.max(1).values < count
        assert sched_all.any()
        p = pos[sched_all]
        assert ((p[:, 0] < p[:, 1]) & (p[:, 1] < p[:, 2])).all()


# ------------------------------------------------------------- kernel I --

def _sphere_grid(kind):
    """The final scene's grid (8 globals, 30 tiles of 24 rows), or the
    final scene with a sixth of its spheres inactive."""
    scene = tb.get_scene("final")
    if kind == "inactive":
        act = scene.active.clone()
        act[torch.nonzero(act)[::6, 0]] = False
        scene = scene._replace(active=act)
    return scene, A.build_grid_accel(scene, time_hi=0.05)


def _sphere_rays(n, rb, seed):
    """Column rays [N, 3], times [N]: half primary-like (from the camera
    region into the scene), half clustered bounce blocks off the ground
    (chip_smoke.py phase 15's batches)."""
    rng = np.random.default_rng(seed)
    h = n // 2
    o1 = np.tile([13.0, 2.0, 3.0], (h, 1)) + rng.normal(0, 0.05, (h, 3))
    d1 = rng.uniform([-12, 0, -12], [12, 2.5, 12], (h, 3)) - o1
    m = n - h
    centers = rng.uniform([-11, 0.0, -11], [11, 0.4, 11], (-(-m // rb), 3))
    o2 = (np.repeat(centers, rb, axis=0)[:m]
          + rng.uniform(-0.5, 0.5, (m, 3)) * [1.0, 0.4, 1.0])
    d2 = rng.normal(0, 0.55, (m, 3)) + [0.0, 1.0, 0.0]
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0, 0.05, n)
    return tuple(torch.as_tensor(x, dtype=torch.float32) for x in (o, d, t))


def sphere_schedule_model(g, o, d, tm, min_t, rb, cols):
    """hit_grid_schedule_kernel in torch on column rays [N, 3]: pass A's
    (t, glob row) over the padded lanes and the schedule row of each
    block."""
    n = o.shape[0]
    nb = -(-n // rb)
    np_ = nb * rb
    fo = torch.zeros((np_, 3))
    fo[:, 1] = -1e9
    fd = torch.zeros((np_, 3))
    if not cols:
        fd[:, 2] = 1.0
    ft = torch.zeros(np_)
    fo[:n], fd[:n], ft[:n] = o, d, tm
    glob = A.glob_table(g)
    t_a, i_a = sweep_packed_model(glob.attrs, [torch.nonzero(glob.active)[:, 0]],
                                  fo, fd, ft, min_t)
    y_lo, y_hi = g.y_slab[0], g.y_slab[1]
    ox, oy, oz = fo.unbind(1)
    dx, dy, dz = fd.unbind(1)
    dy_safe = torch.where(dy.abs() < EPS, torch.where(dy < 0, -EPS, EPS), dy)
    ta, tb = (y_lo - oy) / dy_safe, (y_hi - oy) / dy_safe
    lo_t = tmax(tmin(ta, tb), float(np.float32(min_t)))
    hi_t = tmin(tmax(ta, tb), tmin(t_a, BIG))
    empty = lo_t > hi_t
    inf = float("inf")

    def fold(x, fill, op, init):
        return cta_fold(torch.where(empty, fill, x).reshape(nb, rb), op, init)
    xa, xb, za, zb = ox + lo_t * dx, ox + hi_t * dx, oz + lo_t * dz, oz + hi_t * dz
    fx0, fx1 = fold(tmin(xa, xb), BIG, tmin, inf), fold(tmax(xa, xb), -BIG, tmax, -inf)
    fz0, fz1 = fold(tmin(za, zb), BIG, tmin, inf), fold(tmax(za, zb), -BIG, tmax, -inf)
    bx = g.tile_boxes
    ov = ((fx0[:, None] <= bx[None, :, 1]) & (fx1[:, None] >= bx[None, :, 0])
          & (fz0[:, None] <= bx[None, :, 3]) & (fz1[:, None] >= bx[None, :, 2]))
    return t_a, i_a, ballot_schedule(ov)


def ballot_schedule(ov: torch.Tensor) -> torch.Tensor:
    """The schedule row as the kernel writes it: THREADS tiles at a time,
    a scheduled tile at (scheduled tiles before it), an unscheduled one
    after every scheduled tile at (unscheduled tiles before it)."""
    nb, t = ov.shape
    out = torch.full((nb, 1 + t), -1, dtype=torch.int32)
    count = ov.sum(1)
    out[:, 0] = count
    for b in range(nb):
        before = 0
        for t0 in range(0, t, THREADS):
            chunk = ov[b, t0:t0 + THREADS]
            pos = torch.cumsum(chunk.int(), 0) - chunk.int()   # the ballot prefix
            tid = torch.arange(len(chunk))
            slot = torch.where(chunk, before + pos,
                               count[b] + (t0 - before) + (tid - pos))
            out[b, 1 + slot] = (t0 + tid).int()
            before += int(chunk.sum())
    return out


def _disc(g, j, lj, ox, oy, oz, dx, dy, dz, a):
    """b and disc of every ray against row j of attribute rows g."""
    r = g[j, 8]
    cx = g[j, 0] + g[j, 3] * lj
    cy = g[j, 1] + g[j, 4] * lj
    cz = g[j, 2] + g[j, 5] * lj
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = dx * ocx + dy * ocy + dz * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    return b, b * b - a * c


def sweep_packed_model(attrs, stages, o, d, t, min_t):
    """sweep_packed_rows over staged rows: ``stages`` lists, per stage,
    the table rows staged in order (the active candidates); each stage
    swept by sweep_packed_tile -> (best t, table row, -1 where none)."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    a = dx * dx + dy * dy + dz * dz
    ray = (ox, oy, oz, dx, dy, dz, a)
    best_t = torch.full_like(ox, F32_MAX)
    best_i = torch.full(ox.shape, -1, dtype=torch.int64)
    for rows in stages:
        if not len(rows):
            continue
        g = attrs[rows]
        tv = g[:, 6:8]
        uniform = bool((_bits(tv) == _bits(tv[:1])).all())

        def lerp(j):
            return ((t - tv[0, 0]) * tv[0, 1] if uniform
                    else (t - tv[j, 0]) * tv[j, 1])
        for j0 in range(0, len(rows), CHUNK):
            chunk = range(j0, min(j0 + CHUNK, len(rows)))
            bits = torch.stack([_disc(g, j, lerp(j), *ray)[1] >= 0.0 for j in chunk])
            for k, j in enumerate(chunk):
                b, disc = _disc(g, j, lerp(j), *ray)
                root = (-b - sqrt_rn(torch.clamp_min(disc, 0.0))) / a
                win = bits[k] & (root > min_t) & (root < best_t)
                best_t = torch.where(win, root, best_t)
                best_i = torch.where(win, rows[j], best_i)
    return best_t, best_i


@pytest.mark.parametrize("n_glob", [264, 1024])
def test_sphere_schedule_kernel_refuses_more_globals_than_one_stage(n_glob):
    """The schedule kernel stages the globals once per CTA, one stage of
    256 rows: the launch is refused above that, before any buffer is
    made (the CPU path, the plain version, still serves such a grid)."""
    _, g = _sphere_grid("final")
    rows = g.glob_attrs.new_zeros((n_glob, g.glob_attrs.shape[1]))
    rows[:g.glob_attrs.shape[0]] = g.glob_attrs
    big = g._replace(glob_attrs=rows)
    o, d, tm = _sphere_rays(512, 256, seed=3)
    o, d, tm = o.T.contiguous(), d.T.contiguous(), tm[None]
    with pytest.raises(ValueError, match="global rows > 256"):
        KI.prepare(big, o, d, tm, 0.001, 256, False)
    want = KI.hit_spheres_grid_rows(g, o, d, tm)
    got = KI.hit_spheres_grid_rows(big, o, d, tm)
    assert torch.equal(got.t, want.t) and torch.equal(got.idx, want.idx)
    assert KI.MAX_GLOBALS == 256


def packed_stages(g, sched_row):
    """The sweep kernel's stages for one block: the scheduled tiles' rows
    ascending, STAGE candidates a stage, those with r != 0 staged."""
    st = g.tile_rows
    count = int(sched_row[0])
    cand = (sched_row[1:1 + count, None].long() * st + torch.arange(st)).reshape(-1)
    stages = []
    for c0 in range(0, len(cand), STAGE):
        rows = cand[c0:c0 + STAGE]
        stages.append(rows[g.tile_attrs[rows, 8] != 0.0])
    return stages


@pytest.mark.parametrize("kind", ["final", "inactive"])
@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("n, rb", [(2048, 512), (1800, 256)])
def test_sphere_schedule_kernel_equals_block_schedule(kind, layout, n, rb):
    """Pass A's t and winner and the ballot-and-prefix schedule equal
    kernel I's plain schedule (accel's padding, _sweep, footprint mask and
    argsort schedule), on padded batches too."""
    _, g = _sphere_grid(kind)
    o, d, tm = _sphere_rays(n, rb, seed=n + rb)
    cols = layout == "cols"
    t_a, i_a, sched = sphere_schedule_model(g, o, d, tm, 0.001, rb, cols)
    args = (o, d, tm) if cols else (o.T.contiguous(), d.T.contiguous(), tm[None])
    want_t, want_i, want = KI.schedule_plain(g, *args, 0.001, rb, cols)
    assert torch.equal(sched, want)
    assert torch.equal(_bits(t_a), _bits(want_t)) and torch.equal(i_a, want_i)
    count = want[:, 0]
    assert 0 < int(count.sum()) < count.numel() * g.n_tiles


@pytest.mark.parametrize("t", [1, 30, 255, 256, 257, 600])
def test_ballot_schedule_equals_argsort_schedule(t):
    """The ballot and prefix sum writes accel.block_schedule's row on
    masks of any width, chunks of THREADS tiles included."""
    mask = torch.as_tensor(np.random.default_rng(t).uniform(size=(5, t)) < 0.3,
                           dtype=torch.int32)
    mask[0] = 0
    mask[1] = 1
    assert torch.equal(ballot_schedule(mask > 0), A.block_schedule(mask))


@pytest.mark.parametrize("kind", ["final", "inactive"])
def test_packed_tile_order_equals_sweep_tiles(kind):
    """Kernel I's visiting order (scheduled tiles ascending, rows with
    r != 0, several tiles a stage) gives accel._sweep_tiles's t and
    winning row bit for bit."""
    _, g = _sphere_grid(kind)
    rb = 256
    o, d, tm = _sphere_rays(2048, rb, seed=9)
    _, _, sched = KI.schedule_plain(g, o, d, tm, 0.001, rb, True)
    mask = torch.zeros((sched.shape[0], g.n_tiles), dtype=torch.int32)
    for b in range(sched.shape[0]):
        mask[b, sched[b, 1:1 + int(sched[b, 0])].long()] = 1
    want_t, want_row = A._sweep_tiles(g, o, d, tm, mask, 0.001, rb)
    got_t = torch.empty_like(want_t)
    got_row = torch.empty_like(want_row)
    most = 0
    for b in range(sched.shape[0]):
        ln = slice(b * rb, (b + 1) * rb)
        stages = packed_stages(g, sched[b])
        most = max(most, len(stages))
        got_t[ln], got_row[ln] = sweep_packed_model(
            g.tile_attrs, stages, o[ln], d[ln], tm[ln], 0.001)
    assert torch.equal(_bits(got_t), _bits(want_t))
    assert torch.equal(got_row, want_row)
    assert (want_row >= 0).sum() > 100
    assert most > 1   # some blocks take several stages


def test_packed_order_keeps_the_lowest_row_on_ties():
    """A tile whose rows copy another tile's geometry: the copy comes later
    in the staged order and must lose every exact tie, as in
    _sweep_tiles."""
    _, g = _sphere_grid("final")
    st = g.tile_rows
    attrs = g.tile_attrs.clone()
    attrs[5 * st:6 * st, :9] = attrs[2 * st:3 * st, :9]
    g = g._replace(tile_attrs=attrs)
    rb = 128
    rng = np.random.default_rng(3)
    live = torch.nonzero(attrs[2 * st:3 * st, 8] != 0)[:, 0] + 2 * st
    tgt = attrs[live[torch.as_tensor(rng.integers(0, len(live), rb))], :3]
    o = torch.as_tensor(np.tile([13.0, 2.0, 3.0], (rb, 1)), dtype=torch.float32)
    d = tgt - o
    tm = torch.zeros(rb)
    stages = [torch.cat([torch.arange(2 * st, 3 * st), torch.arange(5 * st, 6 * st)])]
    stages = [s[attrs[s, 8] != 0.0] for s in stages]
    got_t, got_row = sweep_packed_model(attrs, stages, o, d, tm, 0.001)
    mask = torch.zeros((1, g.n_tiles), dtype=torch.int32)
    mask[0, [2, 5]] = 1
    want_t, want_row = A._sweep_tiles(g, o, d, tm, mask, 0.001, rb)
    assert torch.equal(_bits(got_t), _bits(want_t)) and torch.equal(got_row, want_row)
    hit = want_row >= 0
    assert hit.sum() > rb // 2
    assert ((want_row[hit] >= 2 * st) & (want_row[hit] < 3 * st)).all()


def test_sweep_tiles_is_the_tile_table_sweep():
    """Guard on the reference being modelled: _sweep_tiles equals _sweep
    over every scheduled tile's rows with r != 0 (one stage)."""
    _, g = _sphere_grid("final")
    o, d, tm = _sphere_rays(512, 512, seed=4)
    mask = torch.ones((1, g.n_tiles), dtype=torch.int32)
    want_t, want_row = A._sweep_tiles(g, o, d, tm, mask, 0.001, 512)
    tab = SphereTable(g.tile_attrs[:, :16].contiguous(), g.tile_attrs[:, 8] != 0.0)
    t, i = _sweep(tab, o, d, tm, 0.001, 128)
    assert torch.equal(_bits(t), _bits(want_t)) and torch.equal(i, want_row)
