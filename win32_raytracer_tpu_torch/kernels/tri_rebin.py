"""The triangle pass on an occlusion-capped working set (``tri_rebin="on"``;
the reference's ``kernels/tri_rebin.py``).

Kernel D schedules tiles per ray block: a tile is swept when the union of
the block's clipped segments reaches its box.  The scheduler's binning
(persistent._bin_sort_core) sorts the lanes before the sphere pass, so the
sphere hits that cap most segments are invisible to its key and a block
mixes short capped lanes with lanes that cross the mesh.  Here the triangle
pass keys its own working set after the sphere pass:

1. key each lane by (entry cell, capped exit cell, direction octant) on a
   4^3 grid over the scene box, ``_NO_TOUCH`` for a lane whose capped
   segment misses the box (those pack into trailing blocks that schedule
   no tile);
2. sort the working set only (o, d, time, t_cap), never the path state;
3. run the grid pass (kernel D, or its plain version) on the sorted set;
4. put the record back in lane order by the sort's permutation.

The path state keeps its order, so each lane's draws are unchanged and a
render equals the ``tri_rebin="off"`` render exactly (up to kernel D's
cross-tile tie rule), unlike the scheduler's binning.  Torch code around
kernel D, as the reference is XLA code around its Pallas kernel.
"""

from __future__ import annotations

import torch

from ..config import MIN_HIT_T
from ..ops.rows import HitRecordRows
from ..tri_accel import clip_segment_to_box

_NO_TOUCH = 1 << 20
_CELLS = 4


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """3-bit value -> bits at positions 0, 3, 6."""
    return (v & 1) | ((v & 2) << 2) | ((v & 4) << 4)


def capped_chord_keys(scene_box: torch.Tensor, o: torch.Tensor,
                      d: torch.Tensor, t_cap: torch.Tensor,
                      min_t: float = MIN_HIT_T) -> torch.Tensor:
    """int32 sort keys [N] of rays o/d [3, N] capped at ``t_cap`` [N]:
    (box-entry cell 4^3, capped-exit cell 4^3, octant) in 9 + 9 + 3 bits,
    ``_NO_TOUCH`` where the [min_t, t_cap]-clipped segment misses the
    [6] ``scene_box`` (TriGridScene.scene_box)."""
    # 1 / extent rounded to f32, then * 4 (exact), as the reference rounds.
    inv4 = [(1.0 / torch.clamp_min(scene_box[2 * ax + 1] - scene_box[2 * ax],
                                   1e-6)) * 4.0 for ax in range(3)]
    lo_t, hi_t = clip_segment_to_box(scene_box, o, d, t_cap=t_cap,
                                     min_t=min_t)
    no_touch = hi_t < lo_t

    def morton(p):
        code = torch.zeros_like(p[0], dtype=torch.int32)
        for ax in range(3):
            c = (p[ax] - scene_box[2 * ax]) * inv4[ax]
            # Clamp before the cast so out-of-range values saturate alike on
            # every device (the clip after it is the reference's).
            c = torch.clamp(c, -1.0, float(_CELLS)).to(torch.int32)
            code = code | (_spread3(torch.clamp(c, 0, _CELLS - 1)) << ax)
        return code

    lo_c = torch.clamp_min(lo_t, 0.0)
    hi_c = torch.clamp_min(hi_t, 0.0)
    # The box-entry point, not the origin: a lane starting far outside the
    # box lands in the cell where its chord begins.
    entry = [o[ax] + lo_c * d[ax] for ax in range(3)]
    exit_ = [o[ax] + hi_c * d[ax] for ax in range(3)]
    octant = ((d[0] < 0).to(torch.int32) | ((d[1] < 0).to(torch.int32) << 1)
              | ((d[2] < 0).to(torch.int32) << 2))
    key = (morton(entry) << 9) | (morton(exit_) << 3) | octant
    return torch.where(no_touch, _NO_TOUCH, key)


def sorted_tri_pass(tri_fn, grid, o: torch.Tensor, d: torch.Tensor,
                    time: torch.Tensor, t_cap: torch.Tensor,
                    min_t: float = MIN_HIT_T) -> HitRecordRows:
    """``tri_fn(grid, o, d, time, min_t=, t_cap=)`` on the working set sorted
    by :func:`capped_chord_keys`; the record in the original lane order.
    ``t_cap`` [1, N] is the sphere pass's nearest t (or 3.4e38).

    The inverse permutation is a scatter on the unique lane index.  The hit
    point is rebuilt from the original o and d (o + t * d, as every rows
    record computes it) rather than carried back."""
    keys = capped_chord_keys(grid.scene_box, o, d, t_cap[0], min_t=min_t)
    perm = torch.sort(keys, stable=True).indices
    # Gathered rows are new contiguous tensors, as kernel D takes them.
    rec = tri_fn(grid, o[:, perm], d[:, perm], time[:, perm], min_t=min_t,
                 t_cap=t_cap[:, perm])
    cols = {f: x.new_empty(x.shape).index_copy_(1, perm, x)
            for f, x in zip(rec._fields, rec) if f != "point"}
    t_safe = torch.where(cols["hit"], cols["t"], 0.0)
    return HitRecordRows(point=o + t_safe * d, **cols)
