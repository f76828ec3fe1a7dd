"""The triangle pass on a DDA macro-cell expansion (``tri_rebin="dda"``;
the reference's ``kernels/tri_dda.py``).

The working-set sort (kernels/tri_rebin.py) tightens each ray block's tile
union, but every lane still pays its whole block's schedule.  Here each
lane's occlusion-capped chord is marched through a G^3 grid of macro cells
over the scene box and the lane expands into K (cell, chord interval)
pairs:

1. a fixed-K DDA per lane; a lane whose chord visits more than K cells
   falls back to one pair over its whole segment (never wrong);
2. the K * N pairs are sorted by cell (dead pairs last, parked outside
   every tile with cap 0) and go through the grid pass (kernel D or its
   plain version) as one batch: a ray block covers about one cell;
3. pair k >= 1 starts at its interval: its origin shifts to the interval
   start less ``min_t``, so the pass's [min_t, cap] window is the interval,
   and its t is shifted back after;
4. each lane's K records are merged by nearest t.

The windows tile the capped chord and the winning hit lies in one of them,
so the merged record equals the direct pass wherever the hit survives the
cap (t to round-off, from the shifted origins).  Torch code around kernel
D, as the reference is XLA code around its Pallas kernel.
"""

from __future__ import annotations

import torch

from ..config import MIN_HIT_T
from ..ops.hit import F32_MAX
from ..ops.rows import HitRecordRows
from ..tri_accel import clip_segment_to_box

_DEAD_KEY = 1 << 20
_PARK_O = (0.0, -1e9, 0.0)  # the kernels' parked-ray convention
_PARK_D = (0.0, 0.0, 1.0)
_EPS = 1e-12                # the slab test's guard on |d|
_TINY = 1e-5                # the DDA's step past a cell boundary
_NONE_T = 3.4e38            # "no boundary" and the merge's no-hit t


def dda_pairs(scene_box: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
              t_cap: torch.Tensor, g_cells: int = 8, k_max: int = 4,
              min_t: float = MIN_HIT_T):
    """Lanes o/d [3, N] capped at ``t_cap`` [N] expanded into K = ``k_max``
    pair slots, slot-major: (key [K*N] int32, o_p [3, K*N], d_p [3, K*N],
    cap_p [1, K*N], t_off [K*N], lane [K*N] int32).

    Slot 0 keeps the origin (its window [min_t, hi_0] is exact: the chord
    before the box crosses no tile); slots k >= 1 start at their interval.
    An overflow lane (a chord of more than K cells) is one pair over its
    whole segment in slot 0.  Dead slots key ``_DEAD_KEY`` with parked rays
    and cap 0."""
    n = o.shape[1]
    f32 = dict(dtype=torch.float32, device=o.device)
    g = torch.tensor(float(g_cells), **f32)   # a true division on the card
    lo3 = [scene_box[2 * ax] for ax in range(3)]
    csz = [torch.clamp_min(scene_box[2 * ax + 1] - scene_box[2 * ax], 1e-6) / g
           for ax in range(3)]
    dn = [torch.where(d[ax].abs() < _EPS,
                      torch.where(d[ax] < 0, -_EPS, _EPS), d[ax])
          for ax in range(3)]
    lo_t, hi_c = clip_segment_to_box(scene_box, o, d, t_cap=t_cap,
                                     min_t=min_t)
    touch = hi_c >= lo_t

    keys, los, his = [], [], []
    t_cur = lo_t
    for _ in range(k_max):
        live = touch & (t_cur < hi_c)
        t_safe = torch.where(live, t_cur, 0.0)
        # The cell of the point just past the interval start.
        cid = torch.zeros((n,), dtype=torch.int32, device=o.device)
        cs = []
        for ax in range(3):
            p = o[ax] + (t_safe + _TINY) * d[ax]
            c = torch.clamp((p - lo3[ax]) / csz[ax], -1.0, float(g_cells))
            c = torch.clamp(c.to(torch.int32), 0, g_cells - 1)
            cs.append(c)
            cid = cid + c * g_cells ** ax
        # The next boundary crossing after t_cur.
        t_next = torch.full((n,), _NONE_T, **f32)
        for ax in range(3):
            step_to = lo3[ax] + (cs[ax].to(torch.float32)
                                 + (dn[ax] > 0).to(torch.float32)) * csz[ax]
            t_ax = (step_to - o[ax]) / dn[ax]
            t_next = torch.minimum(t_next, torch.where(t_ax > t_cur + _TINY,
                                                       t_ax, _NONE_T))
        t_next = torch.maximum(t_next, t_cur + _TINY)  # guaranteed progress
        keys.append(torch.where(live, cid, _DEAD_KEY))
        los.append(torch.where(live, t_cur, 0.0))
        his.append(torch.where(live, torch.minimum(t_next, hi_c), 0.0))
        t_cur = t_next
    overflow = touch & (t_cur < hi_c)

    lane = torch.arange(n, dtype=torch.int32, device=o.device)
    park_o = o.new_tensor(_PARK_O)[:, None]
    park_d = d.new_tensor(_PARK_D)[:, None]
    key_s, op_s, dp_s, cap_s, off_s = [], [], [], [], []
    for k in range(k_max):
        live = keys[k] != _DEAD_KEY
        if k == 0:
            cap = torch.where(live, torch.where(overflow, hi_c, his[0]), 0.0)
            o_p = torch.where(live, o, park_o)
            off = torch.zeros_like(cap)
        else:
            live = live & ~overflow
            off = los[k] - min_t
            o_p = torch.where(live, o + off * d, park_o)
            cap = torch.where(live, his[k] - off, 0.0)
            off = torch.where(live, off, 0.0)
        key_s.append(torch.where(live, keys[k], _DEAD_KEY))
        op_s.append(o_p)
        dp_s.append(torch.where(live, d, park_d))
        cap_s.append(cap)
        off_s.append(off)
    return (torch.cat(key_s), torch.cat(op_s, 1), torch.cat(dp_s, 1),
            torch.cat(cap_s)[None], torch.cat(off_s), lane.repeat(k_max))


def dda_tri_pass(tri_fn, grid, o: torch.Tensor, d: torch.Tensor,
                 time: torch.Tensor, t_cap: torch.Tensor, g_cells: int = 8,
                 k_max: int = 4, min_t: float = MIN_HIT_T) -> HitRecordRows:
    """``tri_fn`` on the cell-sorted pair expansion of :func:`dda_pairs`; the
    nearest hit over each lane's pairs (t shifted back by the pair's
    offset), in lane order.

    A lane's K slots are taken in the order the reference's unsort leaves
    them, a stable sort by lane of the cell-sorted pairs (cell order, ties
    by slot), and ``torch.argmin`` takes the first of equal t's there, so a
    t tie picks the reference's winner.  The merge indexes the winner's
    fields (a contraction would round integers above 2^24 and may take
    TF32 on a card)."""
    del time
    n = o.shape[1]
    key, o_p, d_p, cap_p, t_off, lane = dda_pairs(
        grid.scene_box, o, d, t_cap[0], g_cells=g_cells, k_max=k_max,
        min_t=min_t)
    perm = torch.sort(key, stable=True).indices
    cap_s, off_s = cap_p[:, perm], t_off[perm]
    rec = tri_fn(grid, o_p[:, perm], d_p[:, perm],
                 torch.zeros_like(cap_s), min_t=min_t, t_cap=cap_s)
    # Beyond its window a hit belongs to another pair: drop it.
    t_true = rec.t[0] + off_s
    hit = rec.hit[0] & (rec.t[0] <= cap_s[0])
    back = torch.sort(lane[perm], stable=True).indices     # lane-major

    def slots(x):  # [rows, K*N] sorted -> [rows, N, K]
        return x[:, back].reshape(x.shape[0], n, k_max)

    hit_l = slots(hit[None])[0]
    t_cand = torch.where(hit_l, slots(t_true[None])[0], _NONE_T)   # [N, K]
    best = torch.argmin(t_cand, dim=1, keepdim=True)               # [N, 1]
    any_hit = hit_l.any(dim=1)
    t_best = torch.gather(t_cand, 1, best)[:, 0]
    merged = {"hit": any_hit[None],
              "t": torch.where(any_hit, t_best, float(F32_MAX))[None]}
    for f, x in zip(rec._fields, rec):
        if f not in merged:
            xs = slots(x)
            merged[f] = torch.gather(
                xs, 2, best[None].expand(xs.shape[0], n, 1))[:, :, 0]
    return HitRecordRows(**merged)
