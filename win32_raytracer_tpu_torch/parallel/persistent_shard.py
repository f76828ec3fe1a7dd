"""The persistent scheduler over a mesh of ranks
(``win32_raytracer_tpu.parallel.persistent_shard``).

Each rank runs the single-card batch loop (``persistent._Loop``: the
bounce routes, the compactors, the split, the bin sort, the one-shot and
staged tails, the run-sum flush) on its own lanes.  This module owns what
exists across ranks: the layout, the per-rank salts, floor and smallest
batch, the lockstep reads and the rank-order reduce.

Work assignment mirrors the reference's interleaved-block thread scheduler
(win32-raytracer/RayTracer.cpp:973-978): rank b owns image row blocks b,
b+D, b+2D, ... of 8 rows, so every rank works the same mix of easy (sky)
and hard (glass, ground) regions and the per-rank alive counts stay
balanced.  That matters because compaction is lockstep: every rank
compacts to the same size, chosen from the largest alive count.

The only traffic between ranks:

* at each alive check, the ranks' alive counts (all-gathered);
* at each stage of the staged tail, every rank's (exit step, count);
* at the end, the [3, H*W] partial images, all-gathered and added in rank
  order on every rank (never an ``all_reduce``, whose order of f32 adds is
  the backend's), so a sharded render repeats bit for bit.

Where the sharded loop differs from the single-card one (the arguments
of ``persistent._Loop``), it follows the reference's sharded scheduler:
the per-rank floor ``max(_COMPACT_FLOOR // D, 1024)`` with 1024 lanes as
the smallest batch, kernel B-multi above the floor under "fused", kernel B
for the single steps at the floor, and whole batches also in the adaptive
second phase.  It never reads ``redistribute`` and refuses
``adaptive_pool="on"``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import persistent as P
from ..adaptive import alloc_lanes
from ..config import RenderConfig
from ..persistent import phase2_salt
from ..utils import profiling
from ..utils.profiling import span
from .shard import (_on_host, all_gather, gather_ints, mesh_rank,
                    rank_device, sum_in_rank_order)

# The smallest batch a rank compacts to (the reference's min_lanes).
_MIN_LANES = 1 << 10


def _interleaved_pixel_lanes(h: int, w: int, kpp: int, d: int,
                             block_rows: int = 8) -> np.ndarray:
    """[D, lanes_per_dev] pixel-lane ids: device b owns row-blocks
    b, b+D, b+2D, ... (reference interleaving, RayTracer.cpp:979-981).
    Rows are padded to a multiple of block_rows*D by wrapping: wrapped
    lanes re-render existing pixels' lane ids with zero quota (inactive).
    Each device's lanes are ascending."""
    n_blocks = -(-h // block_rows)
    pad_blocks = (-n_blocks) % d
    blocks = np.arange(n_blocks + pad_blocks) % n_blocks  # wrap pads
    # Each block's rows; a short last block wraps onto rows 0, 1, ...
    rows = (blocks * block_rows)[:, None] + np.arange(block_rows)
    rows = np.where(rows >= h, rows - h, rows).reshape(-1, d, block_rows)
    rows = rows.transpose(1, 0, 2).reshape(d, -1)         # device b: b::d
    lanes = (rows[:, :, None] * (w * kpp)
             + np.arange(w * kpp)).astype(np.int32).reshape(d, -1)
    # Ascending runs (timsort merges them in linear time).
    return np.sort(lanes, axis=1, kind="stable")


def shard_layout(h_virt: int, w: int, kpp: int, quota: int, d: int, *,
                 quantum: int = 0, pad: bool = True):
    """(lanes [D, n_local] int32, quotas [D, n_local] int32): every rank's
    pixel-lane ids and sample quotas, as the reference's sharded scheduler sets them.

    With ``pad`` each rank's lanes are padded onto the compaction size grid
    (persistent._grid_size) with copies of its own ids, re-sorted; the
    adaptive allocation takes them unpadded.  A lane id seen before, on an
    earlier rank or earlier on the same rank (the short last block wrapped
    onto the rank that owns block 0), gets quota 0, so every pixel-lane id
    renders its quota exactly once."""
    lanes = _interleaved_pixel_lanes(h_virt, w, kpp, d)
    n_local = lanes.shape[1]
    pad_l = P._grid_size(n_local, _MIN_LANES, quantum) - n_local
    if pad_l and pad:
        fill = lanes[:, np.arange(pad_l) % n_local]
        lanes = np.sort(np.concatenate([lanes, fill], axis=1), axis=1,
                        kind="stable")
        n_local += pad_l
    first_seen = np.zeros(h_virt * w * kpp, bool)
    quotas = np.zeros((d, n_local), np.int32)
    for b in range(d):
        ids = lanes[b]                       # ascending: copies adjacent
        fresh = np.ones(n_local, bool)
        fresh[1:] = ids[1:] != ids[:-1]
        fresh &= ~first_seen[ids]
        first_seen[ids] = True
        quotas[b] = np.where(fresh, quota, 0)
    return lanes, quotas


def device_salts(seed: int, d: int) -> list:
    """Each rank's draw salt (the single-card chunk salt with the rank in
    place of the chunk's row)."""
    return [P.chunk_salt(seed, b) for b in range(d)]


class LockstepTimes:
    """Each lockstep collective's elapsed milliseconds on this rank, kept
    only while the recorder is on (``profiling.on()`` at the render's
    start): on NCCL a pair of CUDA timing events on the current stream
    around the gather (no sync), on gloo the host clock around it.
    :meth:`publish` gathers every rank's times into the recorder's table
    ``shard.lockstep_ms`` [ranks, collectives]."""

    def __init__(self, mesh, device):
        self.on = profiling.on()
        self.events = not _on_host(mesh) and device.type == "cuda"
        self.device = device
        self.marks = []

    def gather(self, t: torch.Tensor, mesh) -> list:
        """``all_gather(t, mesh)``, timed while on."""
        if not self.on:
            return all_gather(t, mesh)
        if self.events:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = all_gather(t, mesh)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.marks.append((start, end))
        else:
            t0 = time.perf_counter_ns()
            out = all_gather(t, mesh)
            self.marks.append((time.perf_counter_ns() - t0) / 1e6)
        return out

    def publish(self, mesh) -> None:
        """Every rank's times in rank order, with one all-gather, into the
        recorder (a no-op while off).  The lockstep makes every rank run
        the same collectives, so the counts agree."""
        if not self.on:
            return
        if self.events:
            if self.marks:
                self.marks[-1][1].synchronize()
            ms = [a.elapsed_time(b) for a, b in self.marks]
        else:
            ms = list(self.marks)
        mine = torch.tensor([len(ms)] + ms, dtype=torch.float64)
        if not _on_host(mesh):
            mine = mine.to(self.device)
        rows = torch.stack(all_gather(mine, mesh)).cpu()
        if not bool((rows[:, 0] == len(ms)).all()):
            raise RuntimeError("ranks ran different numbers of lockstep "
                               f"collectives: {rows[:, 0].tolist()}")
        profiling.table("shard.lockstep_ms", rows[:, 1:].tolist())


def _start_counts(alive: torch.Tensor, mesh, gather=all_gather):
    """Start reading every rank's alive count; returns a callable that
    waits for them: (this rank's count, the worst rank's).  As
    persistent._alive_count, the read waits behind the bounces queued
    after this call: on a card the local count (gloo) or the gathered
    counts (NCCL, on the card's stream) are copied back behind an event.
    ``gather`` is the all-gather (:meth:`LockstepTimes.gather`)."""
    cnt = alive.sum().reshape(1).to(torch.int64)
    nccl, b = not _on_host(mesh), mesh_rank(mesh)
    if nccl:
        cnt = torch.cat(gather(cnt, mesh))
    ready = None
    if cnt.device.type == "cuda":
        cnt = cnt.to("cpu", non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()

    def read():
        P.HOST_READS += 1
        with span("shard.lockstep"):
            if ready is not None:
                ready.synchronize()
            counts = (cnt if nccl else torch.cat(gather(cnt, mesh))).numpy()
        return int(counts[b]), int(counts.max())
    return read


@profiling.render_entry("shard.render")
def render_image_persistent_sharded(scene, cam, cfg: RenderConfig, mesh,
                                    hit_fn=None) -> torch.Tensor:
    """Persistent-scheduler render over the mesh; every rank returns linear
    [H, W, 3] f32 on its device.

    Multi-frame batches (the single-card contract, sharded): a LIST of
    cameras renders len(cam) frames as one virtual F * height image whose
    interleaved row blocks shard over the mesh; returns [F, H, W, 3].  An
    explicit rows ``hit_fn`` is called on ``scene`` as passed, as on one
    card."""
    if cfg.adaptive_pool == "on":
        # The pooled estimate needs a chunk's contiguous rows; a rank's
        # interleaved row blocks would pool across rows 8 apart.
        raise ValueError("adaptive_pool='on' is single-chip only")
    dev = rank_device(mesh)
    d, b = mesh.size(), mesh_rank(mesh)
    r = P._prepare(scene.to(dev), cam, cfg, hit_fn, dev)
    w, h, spp, kpp = cfg.width, cfg.height, cfg.samples, r.kpp
    lanes_np, quotas_np = shard_layout(r.h_virt, w, kpp, r.quota, d,
                                       quantum=cfg.compact_quantum,
                                       pad=not r.adaptive)
    n_local = lanes_np.shape[1]
    lanes = torch.from_numpy(lanes_np[b]).to(dev)[None]
    quotas = torch.from_numpy(quotas_np[b]).to(dev)[None]
    salt = device_salts(cfg.seed, d)[b]
    accum = torch.zeros((3, r.h_virt * w), dtype=torch.float32, device=dev)
    times = LockstepTimes(mesh, dev)

    def stage_sync(step, cnt):
        with span("shard.lockstep"):
            got = gather_ints([step, cnt], mesh, gather=times.gather)
        return int(got[:, 0].max()), int(got[:, 1].max())

    loop = P._Loop(
        r, cfg, floor=max(P._COMPACT_FLOOR // d, _MIN_LANES),
        min_lanes=_MIN_LANES, ranks=d, stage_sync=stage_sync,
        start_count=lambda alive: _start_counts(alive, mesh, times.gather),
        multi_above=cfg.multi_backend == "fused", floor_kernel=True)
    # The rank's lanes are its one chunk.
    with span("persistent.chunk"):
        if r.adaptive:
            # Phase 1, the prepass: quota 1 on every fresh lane (0 on the
            # wrap pads).
            st = loop.prepass((lanes, lanes % kpp,
                               (quotas > 0).to(torch.int32)), accum, salt)
            # Phase 2: the rank's remaining samples on lanes allocated by
            # difficulty over its own pixels (wrap pads carry q_rest 0).
            est = st.depth[0].reshape(n_local // kpp, kpp).sum(
                1, dtype=torch.int32)
            pix_ids = lanes[0, ::kpp] // kpp
            q_rest = (quotas[0, ::kpp] > 0).to(torch.int32) * (spp - kpp)
            pix2, s_base2, s_quota2 = alloc_lanes(
                est, n_lanes=n_local, spp_done=kpp, spp=spp,
                kpp_max=cfg.kpp_max, pixel_ids=pix_ids, q_rest=q_rest)
            salt = phase2_salt(salt)
            accum = loop.run_batch((pix2, s_base2, s_quota2), accum, salt,
                                   P._adaptive_phase(cfg, kpp), False,
                                   whole=True)
        else:
            # Each rank's lanes start ascending; binning re-permutes them.
            accum = loop.run_batch((lanes, (lanes % kpp) * r.quota, quotas),
                                   accum, salt, r.uniform, r.state_sorted,
                                   whole=True)

    with span("shard.reduce"):
        total = sum_in_rank_order(all_gather(accum, mesh))
    times.publish(mesh)
    out = P._div(total, spp).T.reshape(r.h_virt, w, 3)
    return out if r.cams is None else out.reshape(len(r.cams), h, w, 3)
