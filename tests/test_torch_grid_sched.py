"""PyTorch port: what the grid kernels' schedule and sweep do, in torch.

Kernels D and I run as two launches each: a schedule kernel that builds on
the card what was a torch prelude, then the sweep.  Their CUDA code cannot
run here, so this file writes the orders and reductions they use in torch
and holds them against the unchanged plain code, exactly:

* kernel D's schedule kernel (csrc/tri_grid.cu tri_grid_schedule_kernel):
  filler rays made in the kernel, the block extremes folded per thread,
  per warp and across warps with torch.minimum / torch.maximum semantics,
  the stable order by (key, tile id): the scheduled tiles with a key
  ranked among themselves (by counting up to a CTA's worth, else by a
  stable LSD radix sort, 8 bits a pass, in chunks of a CTA and warps of
  32), the unscheduled and the NaN-key tiles placed by prefix counts; the
  count and the bounds floored onto the 1/1024 grid, against
  kernels/tri_grid.schedule_plain (tri_block_schedule_rows,
  block_schedule), and the ranking alone against block_schedule on up to
  60,000 tiles;
* kernel I's schedule kernel (csrc/hit_grid.cu hit_grid_schedule_kernel):
  pass A over the globals 256 rows a stage, (t, row) carried between
  stages, the footprint folded in the same order and the tile ids written
  by a ballot and prefix sum, against ops/hit._sweep,
  accel.footprint_block_mask and accel.block_schedule;
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
from win32_raytracer_tpu_torch.scene.spheres import SceneBuilder
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

    sched, bounds = schedule_order_model(key)
    return sched, bounds, cap_eff


PAD = float(KD._TLO_PAD)
DIGIT_BITS = 8


def quant(k):
    """block_schedule's bound: the key floored onto the 1/1024 grid."""
    return (torch.floor(k * float(KD._TLO_SCALE)).to(torch.int32).to(torch.float32)
            * float(KD._TLO_INV))


def ordered_bits(k: torch.Tensor) -> torch.Tensor:
    """csrc/tri_grid.cu ordered_bits: f32 bits (-0 as +0) in unsigned
    order, as int64."""
    u = (k + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u ^ 0x80000000)


def radix_pass(k: torch.Tensor, ids: torch.Tensor, shift: int,
               threads: int = THREADS):
    """One pass of the kernel's stable LSD radix sort: each pair's place is
    its digit's base (the exclusive scan of the digit counts), plus the
    pairs of its digit in earlier chunks of ``threads``, in earlier warps
    of its chunk and at lower lanes of its warp."""
    m = len(k)
    dig = (ordered_bits(k) >> shift) & 255
    base = torch.cumsum(torch.bincount(dig, minlength=256), 0)
    base = base - torch.bincount(dig, minlength=256)
    c = -(-m // threads)
    dpad = torch.full((c * threads,), 256, dtype=torch.int64)
    dpad[:m] = dig
    oh = (dpad[:, None] == torch.arange(256)).to(torch.int32).reshape(
        c, threads // 32, 32, 256)
    below = torch.cumsum(oh, 2) - oh                      # lower lanes
    wtot = oh.sum(2)
    warps_before = torch.cumsum(wtot, 1) - wtot           # earlier warps
    ctot = wtot.sum(1)
    chunks_before = torch.cumsum(ctot, 0) - ctot          # earlier chunks
    e = torch.arange(m)
    ci, wi, li = e // threads, e % threads // 32, e % 32
    place = (base[dig] + chunks_before[ci, dig] + warps_before[ci, wi, dig]
             + below[ci, wi, li, dig])
    out_k, out_i = torch.empty_like(k), torch.empty_like(ids)
    out_k[place], out_i[place] = k, ids
    assert sorted(place.tolist()) == list(range(m))
    return out_k, out_i


def schedule_order_model(key: torch.Tensor, threads: int = THREADS):
    """csrc/tri_grid.cu's order of each row of block keys [NB, T]: the
    scheduled tiles with a key that is not NaN first, by (key, id) (rank
    counting up to ``threads`` of them, else four radix passes), then the
    unscheduled ones (_TLO_PAD) by id, then the NaN keys by id (their
    places by prefix counts in id order) -> (sched [NB, 1+T], bounds
    [NB, T+1]), block_schedule's layouts."""
    nb, t = key.shape
    sched = torch.empty((nb, t + 1), dtype=torch.int32)
    bounds = torch.empty((nb, t + 1), dtype=torch.float32)
    for b in range(nb):
        k = key[b]
        pad = k == PAD
        cls_s, cls_n = (k == k) & ~pad, k != k
        ids_s = torch.nonzero(cls_s)[:, 0]
        ks = k[ids_s]
        n_s, n_pad = len(ids_s), int(pad.sum())
        rest = torch.cat([torch.nonzero(pad)[:, 0], torch.nonzero(cls_n)[:, 0]])
        sched[b, 1 + n_s:] = rest.to(torch.int32)
        bounds[b, n_s:t] = quant(k[rest])
        if n_s <= threads:
            e = torch.arange(n_s)
            rank = ((ks[None, :] < ks[:, None])
                    | ((ks[None, :] == ks[:, None]) & (e[None, :] < e[:, None]))).sum(1)
            sched[b, 1 + rank] = ids_s.to(torch.int32)
            bounds[b, rank] = quant(ks)
        else:
            for p in range(32 // DIGIT_BITS):
                ks, ids_s = radix_pass(ks, ids_s, DIGIT_BITS * p, threads)
            sched[b, 1:1 + n_s] = ids_s.to(torch.int32)
            bounds[b, :n_s] = quant(ks)
        sched[b, 0] = n_s + int(cls_n.sum())
        bounds[b, t] = quant(torch.tensor(PAD))
        assert n_pad + int(cls_n.sum()) + n_s == t
    return sched, bounds


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


def _order_keys(t: int, seed: int):
    """(mask [6, T], tlo [6, T]) for block_schedule: a sparse row whose keys
    take few values (ties); a row with NaN keys among its scheduled tiles;
    a row with nothing scheduled (all _TLO_PAD); a row with every tile
    scheduled and keys on the 1/1024 grid (many ties); the same with NaNs,
    -0.0 and +0.0 keys and keys above _TLO_CAP; a row of distinct keys,
    every tile scheduled."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((6, t), np.int32)
    tlo = np.zeros((6, t), np.float32)
    mask[0] = rng.uniform(size=t) < 0.3
    tlo[0] = rng.integers(0, 7, t) * 0.5
    mask[1] = rng.uniform(size=t) < 0.6
    tlo[1] = rng.uniform(0.001, 40.0, t)
    tlo[1, rng.uniform(size=t) < 0.1] = np.nan
    tlo[2] = rng.uniform(0.001, 40.0, t)
    mask[3:] = 1
    tlo[3] = np.floor(rng.uniform(0.0, 64.0, t) * 1024) / 1024
    tlo[4] = rng.choice(np.array([0.0, -0.0, 3.25, 2e6, np.nan, 1e-3], np.float32), t)
    tlo[5] = rng.permutation(t).astype(np.float32) * 0.37 + 0.001
    return torch.as_tensor(mask), torch.as_tensor(tlo)


@pytest.mark.parametrize("t", [1, 161, 4096, 60000])
def test_tri_schedule_order_equals_block_schedule(t):
    """Kernel D's ranking, few scheduled tiles by counting and many by the
    radix sort, gives block_schedule's sched and bounds on up to 60,000
    tiles: ties keep tile-id order, NaN keys come after the unscheduled
    tiles, all-pad and all-scheduled rows included."""
    mask, tlo = _order_keys(t, seed=t)
    key = torch.where(mask > 0, torch.clamp_max(tlo, float(KD._TLO_CAP)), PAD)
    got = schedule_order_model(key)
    want = KD.block_schedule(mask, tlo)
    assert torch.equal(got[0], want[0])
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert (want[0][2, 0] == 0) and (want[0][3:, 0] == t).all()
    if t > THREADS:
        # The rows with every tile scheduled took the radix sort.
        assert (want[0][3:, 0] > THREADS).all()


@pytest.mark.parametrize("threads", [32, 96, 256])
def test_radix_sort_is_stable_in_every_chunking(threads):
    """The radix sort's places do not depend on the CTA's width (a
    schedule kernel for ray blocks under 256 lanes runs fewer threads):
    four passes give the stable (key, id) order at 32, 96 and 256."""
    _, tlo = _order_keys(3000, seed=5)
    k = torch.clamp_max(tlo[3], float(KD._TLO_CAP))
    ids = torch.arange(3000)
    ks, out = k, ids
    for p in range(4):
        ks, out = radix_pass(ks, out, 8 * p, threads)
    assert torch.equal(out, torch.argsort(k, stable=True))
    assert torch.equal(_bits(ks), _bits(k[out]))


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
    t_a, i_a = sweep_packed_model(glob.attrs, glob_stages(glob), fo, fd, ft,
                                  min_t, chunk=GLOB_CHUNK)
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


def sweep_packed_model(attrs, stages, o, d, t, min_t, chunk=CHUNK):
    """sweep_packed_rows over staged rows: ``stages`` lists, per stage,
    the table rows staged in order (the active candidates); each stage
    swept by sweep_packed_tile in chunks of ``chunk`` rows, (t, row)
    carried from stage to stage -> (best t, table row, -1 where none)."""
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
        for j0 in range(0, len(rows), chunk):
            part = range(j0, min(j0 + chunk, len(rows)))
            bits = torch.stack([_disc(g, j, lerp(j), *ray)[1] >= 0.0 for j in part])
            for k, j in enumerate(part):
                b, disc = _disc(g, j, lerp(j), *ray)
                root = (-b - sqrt_rn(torch.clamp_min(disc, 0.0))) / a
                win = bits[k] & (root > min_t) & (root < best_t)
                best_t = torch.where(win, root, best_t)
                best_i = torch.where(win, rows[j], best_i)
    return best_t, best_i


GLOB_CHUNK = 8      # rows per mask pass over the globals (pass A)


def glob_stages(glob: SphereTable):
    """Pass A's stages: the globals' rows with r != 0 among each STAGE
    rows, ascending (one stage for at most STAGE rows)."""
    rows = glob.attrs.shape[0]
    return [torch.nonzero(glob.active[s0:s0 + STAGE])[:, 0] + s0
            for s0 in range(0, max(rows, 1), STAGE)]


def many_globals_scene(n_big: int, seed: int = 0):
    """A scene whose grid has ``n_big`` globals: the r=1000 ground and
    n_big - 1 spheres of radius 0.7-1.2 over a 60 x 60 floor, among at
    least 600 and twice as many small spheres of radius 0.2 on a jittered
    lattice (the median radius, so every large sphere is above 3x it);
    materials mixed."""
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
    return b.build()


def _many_grid(n_big: int):
    scene = many_globals_scene(n_big)
    g = A.build_grid_accel(scene, time_hi=0.05)
    assert int((g.glob_attrs[:, 8] != 0).sum()) == n_big
    return scene, g


def _wide_rays(n, seed):
    """Column rays over the 60 x 60 floor: half from a camera above it,
    half bounce-like from points near the floor; times [N]."""
    rng = np.random.default_rng(seed)
    h = n // 2
    o1 = np.tile([40.0, 6.0, 40.0], (h, 1)) + rng.normal(0, 0.05, (h, 3))
    d1 = rng.uniform([-30, 0, -30], [30, 1.5, 30], (h, 3)) - o1
    m = n - h
    o2 = rng.uniform([-30, 0.05, -30], [30, 1.0, 30], (m, 3))
    d2 = rng.normal(0, 0.55, (m, 3)) + [0.0, 0.6, 0.0]
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    t = rng.uniform(0, 0.05, n)
    return tuple(torch.as_tensor(x, dtype=torch.float32) for x in (o, d, t))


def _with_rows(g, n_rows: int):
    """The grid with its globals table cut or padded (r = 0 rows) to
    n_rows; rows 300-307, where present, copy rows 1-8's geometry (each
    keeping its own index), so they tie with rows of the first stage."""
    glob = g.glob_attrs
    rows = glob.new_zeros((n_rows, glob.shape[1]))
    k = min(n_rows, glob.shape[0])
    rows[:k] = glob[:k]
    if n_rows > 307:
        rows[300:308, :9] = rows[1:9, :9]
        rows[300:308, 15] = torch.arange(5000, 5008, dtype=torch.float32)
    return g._replace(glob_attrs=rows.contiguous())


@pytest.mark.parametrize("n_rows", [257, 1024])
def test_sphere_schedule_kernel_prepares_any_number_of_globals(n_rows, monkeypatch):
    """The schedule kernel takes any globals table: prepare accepts 257 and
    1,024 global rows and gives the kernel a carry buffer per padded lane
    for pass A's (t, row) between stages; one stage needs none."""
    monkeypatch.setattr(KI._build, "stream_handle", lambda dev: 0)
    _, g = _many_grid(300)
    big = _with_rows(g, n_rows)
    o, d, tm = _wide_rays(3000, seed=1)
    o, d, tm = o.T.contiguous(), d.T.contiguous(), tm[None].contiguous()
    p = KI.prepare(big, o, d, tm, 0.001, 1024, False)
    assert p.args.n_glob == n_rows and p.args.nb == 3
    assert [c.shape for c in p.carry] == [(3 * 1024,), (3 * 1024,)]
    assert p.args.carry_t == p.carry[0].data_ptr() and p.args.carry_i
    one = KI.prepare(_sphere_grid("final")[1], o, d, tm, 0.001, 1024, False)
    assert one.carry is None and one.args.carry_t is None
    assert not hasattr(KI, "MAX_GLOBALS")


@pytest.mark.parametrize("n_rows", [257, 1024])
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_staged_pass_a_equals_sweep(n_rows, layout):
    """Pass A over STAGE rows a stage, (t, row) carried, stages ascending
    with strict <: the schedule kernel's t and original index, and the
    footprint schedule on them, equal its plain version (ops/hit._sweep
    over the whole table) bit for bit, on padded lanes; rows 300-307 tie
    rows 1-8 exactly and lose every tie."""
    _, g = _many_grid(300)
    big = _with_rows(g, n_rows)
    rb = 512
    o, d, tm = _wide_rays(1800, seed=n_rows)
    n_ties = 200
    tgt = big.glob_attrs[torch.as_tensor(np.random.default_rng(2).integers(1, 9, n_ties)), :3]
    d[:n_ties] = tgt - o[:n_ties]
    cols = layout == "cols"
    t_a, i_a, sched = sphere_schedule_model(big, o, d, tm, 0.001, rb, cols)
    args = (o, d, tm) if cols else (o.T.contiguous(), d.T.contiguous(), tm[None])
    want_t, want_i, want = KI.schedule_plain(big, *args, 0.001, rb, cols)
    assert len(glob_stages(A.glob_table(big))) == -(-n_rows // STAGE) > 1
    assert torch.equal(_bits(t_a), _bits(want_t)) and torch.equal(i_a, want_i)
    assert torch.equal(sched, want)
    assert ((want_i >= 1) & (want_i < 9)).sum() > n_ties // 4
    assert not ((want_i >= 300) & (want_i < 308)).any()
    assert (want_i >= STAGE).any()       # later stages win lanes too


@pytest.mark.parametrize("n_big", [257, 1000])
def test_grid_with_many_globals_renders_on_the_plain_path(n_big):
    """A scene with 257 and 1,000 globals (spheres above 3x the median
    radius): the plain grid hit (the wrapper's CPU path) equals the brute
    sweep's t and winners, and a small accel="grid" render through the
    entry point equals the brute render."""
    from win32_raytracer_tpu_torch.api import render
    from win32_raytracer_tpu_torch.config import RenderConfig
    from win32_raytracer_tpu_torch.ops.hit import hit_spheres

    scene, g = _many_grid(n_big)
    assert g.glob_attrs.shape[0] > STAGE
    o, d, tm = _wide_rays(2048, seed=n_big)
    rec = KI.hit_spheres_grid_cols(g, o, d, tm)
    brute = hit_spheres(scene, o, d, tm)
    assert torch.equal(_bits(rec.t), _bits(brute.t))
    assert torch.equal(rec.idx, brute.idx) and torch.equal(rec.hit, brute.hit)
    assert 0.5 < float(brute.hit.float().mean()) < 0.99
    assert (brute.idx[brute.hit] < n_big).sum() > 100      # globals hit
    cfg = RenderConfig(width=32, height=20, samples=1, seed=3,
                       scheduler="persistent")
    grid_img = render(scene, cfg=cfg.replace(accel="grid"), device="cpu").image
    brute_img = render(scene, cfg=cfg, device="cpu").image
    assert np.array_equal(grid_img, brute_img)


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
