"""PyTorch port: the packed triangle sweep of kernels C and H, in torch.

Kernels C and H (csrc/common.cuh ``tri_hit_body``) visit the triangles in
another order than ops/hit_tri.py ``_sweep``: each block stages the active
rows of 256 candidate rows ascending, packed with their original rows;
each chunk of 8 staged triangles is swept twice, once for a mask of the
pairs that may hit (``tri_may_hit``: det and the numerators of u, v and t
by the exact test's own operations, bounds with power-of-two margins, no
division) and once for the exact test of the set bits, ascending, strict
<.
This file writes that order in torch and holds it against ``_sweep``,
``hit_triangles_rows`` and ``hit_triangles`` bit for bit: on the ``mesh``
scene, on tables with inactive and padding rows, on rays aimed at exact
ties (copied triangles, shared edges), through vertices and along edges,
and on tables of several stages (``mesh20k`` among them), with R = 1 and 2
rays a thread.  The mask is held on its own to be a superset of the exact
test on adversarial pairs (u, v at +-0 and a few ulps, u + v at 1, t at
min_t, |det| at 1e-9, underflowing quotients, infinities and NaNs), and
each of its margins is shown to be needed.  The CUDA kernels themselves are
held exactly against the plain versions on the card (chip_smoke.py phases
6 and 13)."""

import numpy as np
import pytest
import torch

from win32_raytracer_tpu_torch.kernels import tri as KC
from win32_raytracer_tpu_torch.kernels import tri_cols as H
from win32_raytracer_tpu_torch.ops.hit import F32_MAX
from win32_raytracer_tpu_torch.ops.hit_tri import (
    TRI_ATTR_COLS, TriTable, _sweep, gather_rows, hit_triangles,
    hit_triangles_rows, tri_pair_t, tri_record_rows_from_gather, tri_table)
from win32_raytracer_tpu_torch.scene.builders import get_scene
from win32_raytracer_tpu_torch.scene.triangles import (
    build_triangle_scene, icosphere_mesh)

torch.set_num_threads(1)

STAGE = 256                  # csrc/common.cuh kBlock: candidate rows a stage
CHUNK = 8                    # triangles per mask pass (common.cuh kTriChunk)
BLOCK = 256                  # threads per block
MIN_T = 0.001                # config.MIN_HIT_T
DET_EPS = np.float32(1e-9)   # csrc/common.cuh kDetEps
SIGN = -(1 << 31)            # the f32 sign bit as an int32
# tri_may_hit's margins: |det| 2^-24 below 0 for u and v, 2^-18 above 1
# for u + v (relative) and below min_t for t.
MARGINS = dict(eps=2.0 ** -24, sum=2.0 ** -18, lo=2.0 ** -18)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def stage_tris_packed(tab: TriTable, base: int, rows: int):
    """csrc/common.cuh stage_tris_packed: the active rows among [base,
    base + rows), ascending -> (geometry columns [K, 9], original rows [K])."""
    idx = torch.nonzero(tab.active[base:base + rows]).flatten() + base
    return tab.attrs[idx, :9], idx


def mask_lo(min_t: float, margin: float = MARGINS["lo"]) -> float:
    """tri_hit_body's lo: min_t (1 - margin) in f32 where min_t >= 2^-64,
    else -inf (t does not filter)."""
    m = np.float32(min_t)
    if not m >= np.float32(2.0 ** -64):
        return float("-inf")
    return float(m * np.float32(1.0 - margin))


def _flip(x: torch.Tensor, sg: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) ^ sg).view(torch.float32)


def may_hit(g: torch.Tensor, o: torch.Tensor, d: torch.Tensor, lo: float,
            eps: float = MARGINS["eps"], sum_margin: float = MARGINS["sum"]):
    """csrc/common.cuh tri_may_hit: triangle columns g [..., 9] against
    rays o/d [..., 3] (broadcast) -> the mask bit of each pair."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = g.unbind(-1)
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    un = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vn = dx * qx + dy * qy + dz * qz
    tn = e2x * qx + e2y * qy + e2z * qz
    ad = det.abs()
    sg = det.contiguous().view(torch.int32) & SIGN
    us, vs, ts = (_flip(x.contiguous(), sg) for x in (un, vn, tn))
    e = ad * eps
    return ((ad >= float(DET_EPS)) & ~(us < -e) & ~(vs < -e)
            & ~(us + vs > ad * (1.0 + sum_margin)) & ~(ts < ad * lo))


def sweep_tris_packed(tab: TriTable, o, d, min_t):
    """csrc/common.cuh tri_hit_body's sweep for rays o/d [n, 3]: stage by
    stage, in chunks of CHUNK staged triangles; a chunk's first pass keeps
    the mask bits, its second runs the exact test (ops/hit_tri.py
    tri_pair_t, the kernels' tri_pair_geom) on the set bits ascending,
    strict < -> (best t, original row, -1 where no hit)."""
    n, s = o.shape[0], tab.attrs.shape[0]
    lo = mask_lo(min_t)
    best_t = torch.full((n,), F32_MAX, dtype=torch.float32)
    best_i = torch.full((n,), -1, dtype=torch.int64)
    for base in range(0, s, STAGE):
        g, rows = stage_tris_packed(tab, base, min(STAGE, s - base))
        for j0 in range(0, len(rows), CHUNK):
            gc = g[j0:j0 + CHUNK]
            bits = may_hit(gc[:, None], o[None], d[None], lo)
            t = tri_pair_t(gc, o.T, d.T, min_t)
            for k in range(len(gc)):
                win = bits[k] & (t[k] < best_t)
                best_t = torch.where(win, t[k], best_t)
                best_i = torch.where(win, rows[j0 + k], best_i)
    return best_t, best_i


def thread_order(n: int, rays: int) -> torch.Tensor:
    """The rays in the order the threads of tri_hit_body hold them: thread
    k of block b sweeps rays b * 256 R + r * 256 + k, r < R; rays past n
    are dropped."""
    nb = -(-n // (BLOCK * rays))
    i = (torch.arange(nb)[:, None, None] * (BLOCK * rays)
         + torch.arange(rays)[None, :, None] * BLOCK
         + torch.arange(BLOCK)[None, None, :])
    i = i.permute(0, 2, 1).reshape(-1)
    return i[i < n]


def kernel_c(tab: TriTable, o, d, min_t, rays):
    """Kernel C in torch: rays o/d [3, N] taken in thread order, swept by
    the packed order, each winner's record (tri_winner_record: the plain
    epilogue) stored at the ray's own index."""
    order = thread_order(o.shape[1], rays)
    bt, bi = sweep_tris_packed(tab, o[:, order].T, d[:, order].T, min_t)
    best_t = torch.empty_like(bt)
    best_i = torch.empty_like(bi)
    best_t[order], best_i[order] = bt, bi
    return tri_record_rows_from_gather(o, d, best_t[None],
                                       gather_rows(tab.attrs, best_i))


def kernel_h(tab: TriTable, o, d, min_t, rays):
    """Kernel H in torch: column rays [N, 3], kernel C's sweep, the column
    record's fields."""
    rec = kernel_c(tab, o.T, d.T, min_t, rays)
    return dict(hit=rec.hit[0], t=rec.t[0], point=rec.point.T,
                normal=rec.normal.T, idx=rec.idx[0], mat_id=rec.mat_id[0],
                albedo=rec.albedo.T, fuzz=rec.fuzz[0], ior=rec.ior[0])


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.is_floating_point():
        return torch.equal(_bits(a), _bits(b))
    return torch.equal(a, b)


# ---------------------------------------------------------------- inputs --

def _mesh_table() -> TriTable:
    return tri_table(get_scene("mesh").triangles)


def _table(kind: str) -> TriTable:
    """The ``mesh`` scene's table (332 triangles padded to 384, two stages)
    and variants: "holes", every fifth triangle inactive besides the
    padding; "ties", rows 260-290 copying the geometry of rows 10-40 (the
    next stage) and rows 100-109 that of rows 50-59 (the same stage), each
    keeping its own index, so the later row must lose every exact tie;
    "nan_pad", the padding rows' geometry NaN and inf (inactive rows are
    never staged, so they cannot win); "many", two icospheres of 1,280
    triangles and a box of 20 (six stages), every seventh inactive;
    "mesh20k", that scene's 20,492 triangles (81 stages)."""
    if kind == "mesh20k":
        return tri_table(get_scene("mesh20k").triangles)
    if kind == "many":
        parts = [icosphere_mesh((0.0, 1.0, 0.0), 1.0, subdivisions=3),
                 icosphere_mesh((2.2, 0.6, 0.4), 0.6, subdivisions=3)]
        offs = np.cumsum([0] + [len(v) for v, _ in parts[:-1]])
        scene = build_triangle_scene(
            np.concatenate([v for v, _ in parts]),
            np.concatenate([f + k for (_, f), k in zip(parts, offs)]))
        tab = tri_table(scene)
        active = tab.active.clone()
        active[3::7] = False
        return TriTable(tab.attrs, active)
    tab = _mesh_table()
    attrs, active = tab.attrs.clone(), tab.active.clone()
    if kind == "holes":
        active[0:332:5] = False
    if kind == "ties":
        for dst, src in ((slice(260, 291), slice(10, 41)), (slice(100, 110), slice(50, 60))):
            attrs[dst, :9] = attrs[src, :9]
    if kind == "nan_pad":
        attrs[332::2, :9] = float("nan")
        attrs[333::2, :9] = float("inf")
    return TriTable(attrs.contiguous(), active.contiguous())


def _rays(tab: TriTable, n: int, seed: int):
    """Rays o/d [n, 3]: a quarter aimed at random points of random active
    triangles (copied rows included), a quarter at the midpoints of their
    edges (shared by two triangles of a closed mesh), a quarter at their
    vertices, and a quarter split between rays along a triangle's edge
    line (det 0) and random directions from the box around the meshes."""
    rng = np.random.default_rng(seed)
    g = tab.attrs[:, :9].numpy().astype(np.float64)
    act = np.flatnonzero(tab.active.numpy())
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    q = n // 4
    o = rng.uniform([-3.0, 0.0, -2.5], [3.0, 3.5, 4.0], (n, 3))
    d = rng.normal(0, 1, (n, 3))
    pick = rng.choice(act, n)
    a = rng.uniform(0, 1, (n, 2))
    a = np.where(a.sum(1, keepdims=True) > 1, 1 - a, a)
    tgt = v0[pick] + a[:, :1] * e1[pick] + a[:, 1:] * e2[pick]
    d[:q] = tgt[:q] - o[:q]
    mid = rng.integers(0, 3, n)
    em = v0[pick] + np.where(mid[:, None] == 0, 0.5 * e1[pick],
                             np.where(mid[:, None] == 1, 0.5 * e2[pick],
                                      0.5 * (e1[pick] + e2[pick])))
    d[q:2 * q] = em[q:2 * q] - o[q:2 * q]
    vx = v0[pick] + np.where(mid[:, None] == 0, 0.0,
                             np.where(mid[:, None] == 1, e1[pick], e2[pick]))
    d[2 * q:3 * q] = vx[2 * q:3 * q] - o[2 * q:3 * q]
    r = 3 * q + (n - 3 * q) // 2
    o[3 * q:r] = v0[pick[3 * q:r]] - 0.5 * e1[pick[3 * q:r]]
    d[3 * q:r] = e1[pick[3 * q:r]]
    return tuple(torch.as_tensor(x, dtype=torch.float32) for x in (o, d))


KINDS = ("mesh", "holes", "ties", "nan_pad", "many")


# ----------------------------------------------------------------- tests --

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("base", [0, 256])
def test_staged_stage_is_the_active_rows(kind, base):
    """A stage holds exactly its candidate rows' active ones, ascending,
    with their original rows and their geometry bit for bit; padding and
    inactive rows never appear."""
    tab = _table(kind)
    s = tab.attrs.shape[0]
    g, rows = stage_tris_packed(tab, base, min(STAGE, s - base))
    act = tab.active.numpy()
    want = [r for r in range(base, min(base + STAGE, s)) if act[r]]
    assert rows.tolist() == want and len(want) > 0
    assert bool(tab.active[rows].all())
    assert torch.equal(_bits(g), _bits(tab.attrs[rows, :9]))
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("min_t", [MIN_T, 0.0])
def test_packed_order_equals_sweep(kind, min_t):
    """Staged order, the mask pass and the exact test of its bits change no
    bit of t and no winner of ops/hit_tri.py _sweep."""
    tab = _table(kind)
    o, d = _rays(tab, 1024, seed=len(kind))
    want_t, want_i = _sweep(tab, o.T, d.T, min_t, 128)
    got_t, got_i = sweep_tris_packed(tab, o, d, min_t)
    assert torch.equal(_bits(got_t), _bits(want_t))
    assert torch.equal(got_i, want_i)
    assert 0.3 < float((want_i >= 0).float().mean()) < 0.95
    if kind == "ties":
        # Rays that meet a copied triangle: the lower row of the pair wins.
        assert (((want_i >= 10) & (want_i < 41)) | ((want_i >= 50) & (want_i < 60))).sum() > 20
        assert not ((want_i >= 260) & (want_i < 291)).any()
        assert not ((want_i >= 100) & (want_i < 110)).any()


def test_edge_and_vertex_rays_meet_several_triangles():
    """The rays at shared edges and vertices do reach pairs that both pass
    the exact test (so the order decides), and the packed order keeps the
    winner and its t."""
    tab = _table("mesh")
    o, d = _rays(tab, 1024, seed=9)
    sel = slice(256, 768)
    t = tri_pair_t(tab.attrs, o[sel].T, d[sel].T, MIN_T)
    t = torch.where(tab.active[:, None], t, F32_MAX)
    tmin = t.min(0).values
    several = ((t == tmin) & (tmin < F32_MAX)).sum(0) > 1
    assert several.sum() > 5          # exact-t ties across two triangles
    assert ((t < F32_MAX).sum(0) > 1).sum() > 100
    want_t, want_i = _sweep(tab, o[sel].T, d[sel].T, MIN_T, 128)
    got_t, got_i = sweep_tris_packed(tab, o[sel], d[sel], MIN_T)
    assert torch.equal(_bits(got_t), _bits(want_t)) and torch.equal(got_i, want_i)


def test_packed_order_on_mesh20k():
    """81 stages of 256 candidate rows (the wavefront's kernel H on
    ``mesh20k``, and kernel C under accel="off")."""
    tab = _table("mesh20k")
    assert tab.attrs.shape[0] > 80 * STAGE
    o, d = _rays(tab, 256, seed=20)
    want_t, want_i = _sweep(tab, o.T, d.T, MIN_T, 128)
    got_t, got_i = sweep_tris_packed(tab, o, d, MIN_T)
    assert torch.equal(_bits(got_t), _bits(want_t))
    assert torch.equal(got_i, want_i)
    assert float((want_i >= 0).float().mean()) > 0.3


@pytest.mark.parametrize("kind", ("mesh", "ties", "many"))
@pytest.mark.parametrize("rays", [1, 2])
def test_kernel_c_order_equals_hit_triangles_rows(kind, rays):
    """Kernel C's form: rows rays [3, N] (N not a multiple of a block), R
    rays a thread, the packed order, the record by index, equal to
    ops/hit_tri.py hit_triangles_rows bit for bit."""
    tab = _table(kind)
    o, d = _rays(tab, 700, seed=3 * rays + len(kind))
    o, d = o.T.contiguous(), d.T.contiguous()
    got = kernel_c(tab, o, d, MIN_T, rays)
    want = hit_triangles_rows(tab, o, d, torch.zeros((1, o.shape[1])))
    for f in want._fields:
        assert _same(getattr(got, f), getattr(want, f)), f
    assert 0.3 < float(want.hit.float().mean()) < 0.95


@pytest.mark.parametrize("kind", ("mesh", "holes", "nan_pad"))
@pytest.mark.parametrize("rays", [1, 2])
def test_kernel_h_order_equals_hit_triangles(kind, rays):
    """Kernel H's form: column rays [N, 3], R rays a thread, equal to
    ops/hit_tri.py hit_triangles bit for bit (zeros on a miss)."""
    tab = _table(kind)
    o, d = _rays(tab, 600, seed=5 * rays + len(kind))
    got = kernel_h(tab, o, d, MIN_T, rays)
    want = hit_triangles(tab, o, d, torch.zeros(o.shape[0]))
    for f in want._fields:
        assert _same(got[f], getattr(want, f)), f
    miss = ~want.hit
    assert miss.any() and not got["albedo"][miss].any()


# ------------------------------------------------ the mask is a superset --

def exact_parts(g, o, d, min_t):
    """tri_pair_t's intermediates for one ray per triangle (g [N, 9], o/d
    [N, 3]): det, un, vn, tn, u, v, t and valid, by its operations."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = g.unbind(-1)
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() >= float(DET_EPS)
    one = det.new_ones(())
    inv_det = one / torch.where(ok, det, one)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    un = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vn = dx * qx + dy * qy + dz * qz
    tn = e2x * qx + e2y * qy + e2z * qz
    u, v, t = un * inv_det, vn * inv_det, tn * inv_det
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > min_t)
    return dict(det=det, un=un, vn=vn, tn=tn, u=u, v=v, t=t, valid=valid)


def _ulps(x: np.ndarray, k) -> np.ndarray:
    """x moved k f32 ulps (k may be negative; through 0 into the other
    sign), elementwise."""
    x = np.array(x, np.float32)
    k = np.broadcast_to(np.asarray(k), x.shape)
    for step in range(int(np.abs(k).max(initial=0))):
        x = np.where(k > step, np.nextafter(x, np.float32(np.inf)),
                     np.where(-k > step, np.nextafter(x, np.float32(-np.inf)), x))
    return x.astype(np.float32)


def adversarial_pairs(min_t: float, seed: int = 0):
    """Triangles g [N, 9] and one ray each, o/d [N, 3], on the exact test's
    boundaries.

    Family A is axis-aligned: v0 = 0, e1 = (a, 0, 0), e2 = (0, 1, 0), the
    ray from (x, y, h) along (0, 0, -1), so det = a, un = x, vn = y a and
    tn = h a, each with one rounding at most: a runs over |det| at 1e-9 +-
    ulps, 1e-9 to 1e38 and 2^126 to 3.4e38 (inv_det subnormal), both signs,
    and x, y, h put u, v and t at +-0 and a few ulps either side, u + v at
    1 +- ulps, t at min_t +- ulps, the quotients below f32's range (u =
    -0 from a negative un), and infinities and NaNs in a, x, y and h or
    from products that overflow.
    Family B is general: random triangles and rays aimed at points with u
    or v at 0, u + v at 1 or a vertex, from origins at about min_t before
    the plane or anywhere."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n = 6000
    mag = np.exp(rng.uniform(np.log(1e-9), np.log(1e38), n)).astype(f32)
    mag[:600] = _ulps(np.full(600, DET_EPS), rng.integers(-4, 5, 600))
    mag[600:900] = f32(2.0) ** rng.integers(-29, 127, 300).astype(f32)
    # 1 / det subnormal: inv_det errs by up to 2^-22 (the t bound's case).
    mag[900:1800] = np.exp(rng.uniform(np.log(2.0 ** 126), np.log(3.4e38), 900)).astype(f32)
    a = np.where(rng.uniform(size=n) < 0.5, -mag, mag).astype(f32)
    s = np.sign(a).astype(f32)
    k = rng.integers(-3, 4, (n, 3))
    # Targets for u, v, t and how x, y, h reach them.
    kind = rng.integers(0, 6, n)
    u_t = rng.uniform(0, 1, n).astype(f32)
    v_t = (rng.uniform(0, 1, n) * (1 - u_t)).astype(f32)
    zero = np.zeros(n, f32)
    tiny = (f32(2.0) ** rng.integers(-149, -100, n).astype(f32))
    margin_u = (np.abs(a) * f32(2.0 ** -24)).astype(f32)
    x = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                  [_ulps(zero, k[:, 0]) * s,                 # u at +-0
                   _ulps(-margin_u, k[:, 0]) * s,            # us at -|det| 2^-24
                   -tiny * s,                                # u = -0 by underflow
                   (u_t * a).astype(f32)],
                  (u_t * a).astype(f32))
    y = np.select([kind == 4, kind == 5],
                  [_ulps(f32(1) - u_t, k[:, 1]),             # u + v at 1
                   _ulps(zero, k[:, 1])],                    # v at +-0
                  v_t).astype(f32)
    y = np.where(kind == 2, f32(0.25), y)
    h = np.where(rng.uniform(size=n) < 0.5,
                 _ulps(np.full(n, f32(min_t)), k[:, 2]),     # t at min_t
                 rng.uniform(min_t, 10, n)).astype(f32)
    # A few with infinities and NaNs, and finite values whose products
    # overflow (vn = y a and tn = h a: +-inf from finite inputs).
    for col, vals in ((a, (np.inf, -np.inf, np.nan, 3e38)),
                      (x, (np.inf, -np.inf, np.nan)),
                      (y, (np.inf, np.nan, 3e38)), (h, (np.inf, -np.inf, np.nan, 3e38))):
        sel = rng.choice(n, 120, replace=False)
        col[sel] = rng.choice(np.asarray(vals, f32), 120)
    # The t bound's corner: 1 / det subnormal and rounded up, tn the float
    # just below RN(det min_t), yet t = RN(tn inv_det) above min_t (found
    # by search among such dets; u = v = 1/4).
    if min_t > 0:
        m = f32(min_t)
        big = np.exp(rng.uniform(np.log(2.0 ** 126), np.log(3.4e38), 40000)).astype(f32)
        tn = np.nextafter((big * m).astype(f32), f32(0))
        hb = (tn / big).astype(f32)
        corner = (((hb * big).astype(f32) == tn)
                  & ((tn * (f32(1) / big).astype(f32)).astype(f32) > m))
        big, hb = big[corner][:300], hb[corner][:300]
        a = np.concatenate([a, big])
        x = np.concatenate([x, (f32(0.25) * big).astype(f32)])
        y = np.concatenate([y, np.full(len(big), f32(0.25))])
        h = np.concatenate([h, hb])
    ga = np.zeros((len(a), 9), f32)
    ga[:, 3] = a
    ga[:, 7] = 1.0
    oa = np.stack([x, y, h], 1)
    da = np.tile(np.asarray([0.0, 0.0, -1.0], f32), (len(a), 1))

    m = 6000
    v0 = rng.normal(0, 2, (m, 3))
    e1 = rng.normal(0, 1, (m, 3)) * np.exp(rng.uniform(-12, 12, (m, 1)))
    e2 = rng.normal(0, 1, (m, 3)) * np.exp(rng.uniform(-12, 12, (m, 1)))
    bu = rng.uniform(0, 1, m)
    bv = rng.uniform(0, 1, m) * (1 - bu)
    kb = rng.integers(0, 5, m)
    bu = np.select([kb == 0, kb == 3], [0.0, 0.0], bu)
    bv = np.select([kb == 1, kb == 2, kb == 3], [0.0, 1 - bu, 1.0], bv)
    tgt = v0 + bu[:, None] * e1 + bv[:, None] * e2
    db = rng.normal(0, 1, (m, 3))
    dist = np.where(rng.uniform(size=m) < 0.5,
                    min_t * (1 + rng.normal(0, 1e-6, m)), rng.uniform(0, 5, m))
    ob = tgt - dist[:, None] * db
    gb = np.concatenate([v0, e1, e2], 1).astype(f32)
    t = (lambda z: torch.as_tensor(np.asarray(z, f32)))
    return (t(np.concatenate([ga, gb])), t(np.concatenate([oa, ob])),
            t(np.concatenate([da, db])))


@pytest.mark.parametrize("min_t", [MIN_T, 0.0, 0.25])
def test_mask_keeps_every_pair_the_exact_test_accepts(min_t):
    """tri_may_hit is a superset of the exact test on adversarial pairs,
    which do reach every boundary its bounds are proved on."""
    g, o, d = adversarial_pairs(min_t)
    ex = exact_parts(g, o, d, min_t)
    # exact_parts is the reference op: tri_pair_t's diagonal, bit for bit.
    for i0 in range(0, len(g), 500):
        sl = slice(i0, i0 + 500)
        ref = tri_pair_t(g[sl], o[sl].T, d[sl].T, min_t).diagonal()
        assert torch.equal(_bits(ref), _bits(torch.where(ex["valid"][sl], ex["t"][sl], F32_MAX)))
    keep = may_hit(g, o, d, mask_lo(min_t))
    valid = ex["valid"]
    assert bool((keep | ~valid).all()), int((valid & ~keep).sum())
    # Coverage of the boundaries.
    u, v, t, det = ex["u"], ex["v"], ex["t"], ex["det"]
    neg0 = (u == 0) & (_bits(u) < 0)
    assert int(valid.sum()) > 1500 and int((~valid).sum()) > 1500
    assert int((valid & neg0).sum()) > 10                       # u = -0
    assert int((valid & neg0 & (ex["un"] != 0)).sum()) > 10     # by underflow
    assert int((valid & (u == 0) & ~neg0).sum()) > 10           # u = +0
    assert int((valid & (v == 0)).sum()) > 10                   # v = +-0
    assert int(((u < 0) & (u > -1e-30)).sum()) > 10             # u just below 0
    assert int((valid & (u + v == 1.0)).sum()) > 50             # u + v at 1
    assert int(((u >= 0) & (v >= 0) & (u + v > 1.0) & (u + v < 1.0 + 1e-6)).sum()) > 10
    ad = det.abs()
    at_eps = (ad > DET_EPS * 0.999999) & (ad < DET_EPS * 1.000001)
    assert int((at_eps & (ad >= DET_EPS)).sum()) > 50 and int((at_eps & (ad < DET_EPS)).sum()) > 50
    assert int((~torch.isfinite(det)).sum()) > 10
    for key in ("un", "vn", "tn"):
        assert int(torch.isnan(ex[key]).sum()) > 5 and int(torch.isinf(ex[key]).sum()) > 5
    if min_t > 0:
        near = (t > min_t * (1 - 1e-6)) & (t < min_t * (1 + 1e-6))
        assert int((valid & near).sum()) > 50 and int((near & (t <= min_t)).sum()) > 50


@pytest.mark.parametrize("margin", ["eps", "sum", "lo"])
def test_each_margin_of_the_mask_is_needed(margin):
    """With any one margin set to zero the mask drops pairs that the exact
    test accepts on the same adversarial set: the superset test above
    would fail."""
    g, o, d = adversarial_pairs(MIN_T)
    valid = exact_parts(g, o, d, MIN_T)["valid"]
    kw = {"eps": dict(eps=0.0), "sum": dict(sum_margin=0.0), "lo": {}}[margin]
    lo = mask_lo(MIN_T, 0.0 if margin == "lo" else MARGINS["lo"])
    keep = may_hit(g, o, d, lo, **kw)
    assert int((valid & ~keep).sum()) > 0


def test_mask_lo_is_minus_inf_below_its_range():
    """min_t at or below 2^-64 (0 among them), or NaN, turns the t bound
    off; above it lo is min_t (1 - 2^-18) in f32."""
    assert mask_lo(0.0) == float("-inf") and mask_lo(2.0 ** -65) == float("-inf")
    assert mask_lo(float("nan")) == float("-inf")
    assert mask_lo(MIN_T) == float(np.float32(MIN_T) * np.float32(1 - 2.0 ** -18))
    assert mask_lo(MIN_T) < np.float32(MIN_T)


@pytest.mark.parametrize("who, call", [
    ("hit_triangles_rows", lambda tab, o, d, r: KC.hit_triangles_rows(
        tab, o.T.contiguous(), d.T.contiguous(), torch.zeros((1, o.shape[0])), _rays=r)),
    ("hit_triangles_cols", lambda tab, o, d, r: H.hit_triangles_cols(
        tab, o, d, torch.zeros(o.shape[0]), _rays=r))])
def test_c_and_h_wrappers_validate_their_launch_form(who, call):
    """As kernel A's wrapper: the forced form must be 1 or 2 rays per
    thread on every device; on the CPU any valid form is the plain version
    and counts no launch."""
    tab = _table("mesh")
    o, d = _rays(tab, 64, seed=3)
    for bad in (0, 3, 4):
        with pytest.raises(ValueError, match=f"{who}: _rays must be 1 or 2"):
            call(tab, o, d, bad)
    before = (KC.LAUNCHES, H.LAUNCHES)
    outs = [call(tab, o, d, r) for r in (None, 1, 2)]
    for rec in outs[1:]:
        assert all(_same(x, y) for x, y in zip(rec, outs[0]))
    assert (KC.LAUNCHES, H.LAUNCHES) == before


def test_tri_columns_are_the_kernel_layout():
    """The column numbers csrc/common.cuh TriCol and stage_tris_packed use:
    v0, e1, e2 in columns 0-8 of 16."""
    assert TRI_ATTR_COLS == 16
    scene = get_scene("mesh").triangles
    tab = tri_table(scene)
    assert torch.equal(tab.attrs[:, 0:3], scene.v0)
    assert torch.equal(tab.attrs[:, 3:6], scene.e1)
    assert torch.equal(tab.attrs[:, 6:9], scene.e2)
