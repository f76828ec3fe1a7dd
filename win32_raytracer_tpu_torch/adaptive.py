"""Difficulty-adaptive lane allocation for the persistent scheduler (the
reference's ``adaptive.py``).

With a uniform ``lanes_per_pixel`` K, every lane of a hard pixel (glass
over the ground) carries spp/K samples of paths several times the mean
length, so the batch ends on a few long lanes.  ``adaptive_alloc="on"``
allocates each pixel lanes in proportion to its measured difficulty at a
fixed lane budget.  The difficulty comes from a prepass of quota-1 lanes:
the final depth of such a lane is its sample's path length (depth freezes
when the path ends), so the prepass both adds its samples to the image and
measures the estimate.  Lanes of one pixel are contiguous, so the estimate
is a reshape-sum.

:func:`alloc_lanes` builds the second phase's lane arrays on the render's
device by scatters and prefix sums, with no host round trip.
"""

from __future__ import annotations

from typing import Optional

import torch


# XLA's CPU cumsum is a blocked scan: sequential within blocks of this many
# entries, the block totals scanned the same way, recursively.
_SCAN_BLOCK = 16


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of the f32 vector ``x`` in XLA's CPU association
    (blocks of ``_SCAN_BLOCK``, the block totals scanned recursively), bit
    for bit, in elementwise adds whose order is fixed: the same sums on
    every device.  ``torch.cumsum`` on a card scans by decoupled look-back,
    whose f32 association changes from run to run, and moved the adaptive
    allocation's boundaries between two headlines."""
    b = _SCAN_BLOCK
    n = x.shape[0]
    if n <= b:
        out = x.clone()
        for i in range(1, n):
            out[i] = out[i - 1] + x[i]
        return out
    nb = -(-n // b)
    xp = torch.nn.functional.pad(x, (0, nb * b - n)).reshape(nb, b)
    within = xp.clone()
    for k in range(1, b):
        within[:, k] = within[:, k - 1] + xp[:, k]
    pre = cumsum_f32(within[:, -1].contiguous())
    out = within.clone()
    out[1:] = within[1:] + pre[:-1, None]
    return out.reshape(-1)[:n]


def alloc_lanes(est: torch.Tensor, *, n_lanes: int, spp_done: int, spp: int,
                kpp_max: int = 32, pixel_ids: Optional[torch.Tensor] = None,
                q_rest: Optional[torch.Tensor] = None):
    """The second phase's lane arrays from per-pixel difficulty estimates.

    est       [P] f32 or int32, nonnegative (a pixel's prepass path steps;
              any monotone difficulty proxy).
    n_lanes   L, the lane budget (L >= P: every pixel gets >= 1 lane).
    spp_done  samples already rendered per pixel (the prepass).
    spp       samples per pixel in all; the phase renders spp - spp_done.
    kpp_max   soft cap on lanes per pixel (the hard cap is the remaining
              samples: a lane needs one; rounding may pass the soft cap by
              a few lanes).
    pixel_ids optional [P] int32: the pixel ids to emit (default
              arange(P)), for a shard's own pixel set.
    q_rest    optional [P] int32: each pixel's remaining samples (default
              spp - spp_done); 0 marks a pixel whose lanes never run.

    Returns (pixel, s_base, s_quota), each [1, L] int32, a pixel's lanes
    contiguous (ascending ids stay ascending).  Exact by construction: every
    pixel owns >= 1 lane, the lane counts sum to L, and each pixel's lanes
    partition [spp_done, spp_done + q_rest) disjointly and completely.  The
    boundaries come from an f32 cumsum of the weights in a fixed order
    (:func:`cumsum_f32`), so two runs on a card give the same arrays; the
    weights' normalising sums are each device's own reductions, so a
    boundary may still move by one lane between devices, never the
    accounting."""
    p = est.shape[0]
    dev = est.device
    i32 = dict(dtype=torch.int32, device=dev)
    spp_rest = spp - spp_done
    if n_lanes < p:
        raise ValueError(f"alloc_lanes: {n_lanes} lanes for {p} pixels")
    kmax = min(kpp_max, spp_rest)
    pool = n_lanes - p                  # lanes beyond one per pixel

    # A proportional share of the pool, capped softly at ~kmax lanes a pixel
    # (one renormalisation); a zero estimate everywhere is guarded.
    w = est.to(torch.float32)
    w = w / torch.clamp_min(w.sum(), 1e-30)
    w = torch.clamp_max(w, kmax / max(n_lanes, 1))
    w = w / torch.clamp_min(w.sum(), 1e-30)
    # Boundaries clamped to the pool, the last one forced, and made
    # monotone by a running max: the differences are >= 0 and sum to the
    # pool.  (A blocked f32 scan is not monotone: where a zero weight
    # follows a block's end the sum can step down by an ulp, and rounding
    # can turn that into a pixel with no lane; the reference has no running
    # max.)
    bnd = torch.round(cumsum_f32(w) * pool).to(torch.int32)
    bnd = torch.clamp_max(bnd, pool)
    bnd[-1] = pool
    bnd = torch.cummax(bnd, 0).values
    kpp_p = torch.diff(bnd, prepend=bnd.new_zeros(1)) + 1    # lanes a pixel
    starts = torch.cumsum(kpp_p, 0, dtype=torch.int32) - kpp_p

    def to_lanes(vals):
        """Per-pixel values broadcast to their lanes: the differences
        placed at each pixel's first lane (unique indices), prefix-summed."""
        vals = vals.to(torch.int32)
        z = torch.zeros((n_lanes,), **i32).index_copy_(
            0, starts.long(), torch.diff(vals, prepend=vals.new_zeros(1)))
        return torch.cumsum(z, 0, dtype=torch.int32)

    if pixel_ids is None:
        pixel_ids = torch.arange(p, **i32)
    pixel = to_lanes(pixel_ids)
    kpp_l = to_lanes(kpp_p)
    rank = torch.arange(n_lanes, **i32) - to_lanes(starts)
    # The pixel's remaining samples split among its lanes, the first
    # (rest % lanes) lanes one more.
    rest_l = spp_rest if q_rest is None else to_lanes(q_rest)
    q_div = rest_l // kpp_l
    q_mod = rest_l % kpp_l
    s_quota = q_div + (rank < q_mod).to(torch.int32)
    s_base = spp_done + rank * q_div + torch.minimum(rank, q_mod)
    return pixel[None], s_base[None], s_quota[None]
