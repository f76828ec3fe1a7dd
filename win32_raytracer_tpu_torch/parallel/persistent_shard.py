"""The persistent scheduler over a mesh of ranks
(``win32_raytracer_tpu.parallel.persistent_shard``).

Each rank runs the single-card scheduler's steps (persistent.py: the
bounces of :func:`persistent.resolve_routes`, the compactors, the split,
the bin sort, the one-shot and staged tails, the run-sum flush) on its
own lanes; the host loop around them is the reference's sharded loop, in
lockstep over the ranks.

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

Where the sharded loop differs from the single-card one, it follows the
reference's sharded scheduler: the per-rank floor
``max(_COMPACT_FLOOR // D, 1024)`` with 1024 lanes as the smallest batch;
the fused bounce (kernel B) above the floor and, under
``multi_backend="fused"``, k bounces per launch of kernel B above it; a
batch that starts at or below the floor runs whole in the one-shot forms,
also in the adaptive second phase; per-rank draw salts.  At or below the
floor the reference takes the torch k-bounce; here, as in the single-card
loop, every bounce there runs on kernels B-multi and B wherever the render
has kernel B (``routes.tail_multi``: not under ``multi_backend="xla"``),
the same bounces bit for bit in a fraction of the launches, and on the
torch chain otherwise.  Like the reference's sharded scheduler
it never reads ``redistribute`` and refuses ``adaptive_pool="on"``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import persistent as P
from ..adaptive import alloc_lanes
from ..config import RenderConfig
from ..scene.camera import Camera, default_camera
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
    return [(seed * 0x9E3779B1 ^ (b + 1) * 0x85EBCA77) & 0xFFFFFFFF
            for b in range(d)]


def phase2_salt(salt: int) -> int:
    """The adaptive second phase's salt of a rank."""
    return (salt * 0x85EBCA77 + 0x632BE5AB) & 0xFFFFFFFF


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
    waits for them ([D] int64, rank order).  As persistent._alive_count,
    the read waits behind the bounces queued after this call: on a card
    the local count (gloo) or the gathered counts (NCCL, on the card's
    stream) are copied back behind an event.  ``gather`` is the
    all-gather (:meth:`LockstepTimes.gather`)."""
    cnt = alive.sum().reshape(1).to(torch.int64)
    nccl = not _on_host(mesh)
    if nccl:
        cnt = torch.cat(gather(cnt, mesh))
    ready = None
    if cnt.device.type == "cuda":
        cnt = cnt.to("cpu", non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()

    def read() -> np.ndarray:
        P.HOST_READS += 1
        with span("shard.lockstep"):
            if ready is not None:
                ready.synchronize()
            if nccl:
                return cnt.numpy()
            return torch.cat(gather(cnt, mesh)).numpy()
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
    from ..kernels.bounce import pack_camera, pack_cameras, unpack_camera
    from ..kernels.dispatch import get_hit_fn_rows_accel

    P.check_supported(cfg, scene)
    dev = rank_device(mesh)
    d, b = mesh.size(), mesh_rank(mesh)
    scene = scene.to(dev)
    cams, n_frames = None, 1
    if isinstance(cam, (list, tuple)) and not isinstance(cam, Camera):
        cams = [c.to(dev) for c in cam]
        n_frames = len(cams)
        if n_frames == 0:
            raise ValueError("empty camera list")
        if n_frames == 1:
            cam = cams[0]
    if cam is None:
        cam = default_camera(cfg.width, cfg.height, device=dev)
    w, h, spp = cfg.width, cfg.height, cfg.samples
    h_virt = h * n_frames
    if n_frames > 1:
        cam_rows = pack_cameras(cams)
        cam = unpack_camera(cam_rows)
    else:
        cam = cam.to(dev)
        cam_rows = pack_camera(cam)
    own_hit_fn = hit_fn is not None
    if own_hit_fn:
        hit_scene = scene
    else:
        hit_scene, hit_fn = get_hit_fn_rows_accel(
            cfg, scene, cams[0] if cams else cam)
    bin_box = P._derive_bin_box(cfg, hit_scene)
    if cfg.compact_quantum < 0:
        raise ValueError(f"compact_quantum must be >= 0 (0 = auto), got "
                         f"{cfg.compact_quantum}")
    if not (cfg.compact_shrink == 0.0 or 0.0 < cfg.compact_shrink < 1.0):
        raise ValueError(f"compact_shrink must be 0 (auto) or in (0, 1), "
                         f"got {cfg.compact_shrink}")
    shrink = cfg.compact_shrink or P._COMPACT_SHRINK
    kpp = P._resolve_kpp(cfg, spp, n_frames, w * h)
    quota = spp // kpp
    adaptive = cfg.adaptive_alloc == "on"
    if adaptive and not (kpp > 1 and spp > kpp and bin_box is None):
        raise ValueError(
            "adaptive_alloc='on' needs an unbinned render with "
            "lanes_per_pixel > 1 and samples > lanes_per_pixel "
            f"(got kpp={kpp}, samples={spp}, "
            f"ray_binning={'active' if bin_box else 'off'})")
    if cfg.adaptive_pool == "on":
        # The pooled estimate needs a chunk's contiguous rows; a rank's
        # interleaved row blocks would pool across rows 8 apart.
        raise ValueError("adaptive_pool='on' is single-chip only")
    if h_virt * w * kpp >= (1 << 29):
        raise ValueError(
            f"pixel-lane ids must stay below 2^29 "
            f"(width*height*frames*lanes_per_pixel = {h_virt * w * kpp})")
    # The bounce routes of one card (kernels B, E, F, B-multi and the hit
    # functions), and the one-shot form ("auto": "chunk" unless a conflict).
    routes = P.resolve_routes(cfg, hit_scene, dev, h_virt=h_virt, kpp=kpp,
                              bin_box=bin_box, own_hit_fn=own_hit_fn)
    lean = not (cfg.stratify and spp > 1) and not cfg.russian_roulette
    mk = cfg.multi_k or P._MULTI_K
    check_period = cfg.check_period or 8
    min_lanes = _MIN_LANES
    floor = max(P._COMPACT_FLOOR // d, min_lanes)
    use_route = (cfg.compactor or "sort") == "route"
    flush_mode = cfg.flush_mode or "scatter"

    def fused_tail(st, salt_s, step0, k, dims):
        """``k`` bounces at steps step0..step0+k-1 at or below the floor:
        runs of ``mk`` on kernel B-multi, the rest on kernel B."""
        while k >= mk:
            st = routes.tail_multi(hit_scene, cam_rows, st, salt_s, step0,
                                   dims, cfg=cfg, k=mk, lean=lean)
            step0, k = step0 + mk, k - mk
        for step in range(step0, step0 + k):
            st = routes.fused(hit_scene, cam_rows, st, salt_s, step, dims,
                              cfg=cfg, lean=lean)
        return st

    kernel_tail = fused_tail if routes.tail_multi is not None else None

    lanes_np, quotas_np = shard_layout(h_virt, w, kpp, quota, d,
                                       quantum=cfg.compact_quantum,
                                       pad=not adaptive)
    n_local = lanes_np.shape[1]
    lanes = torch.from_numpy(lanes_np[b]).to(dev)[None]
    quotas = torch.from_numpy(quotas_np[b]).to(dev)[None]
    salt = device_salts(cfg.seed, d)[b]
    accum = torch.zeros((3, h_virt * w), dtype=torch.float32, device=dev)
    times = LockstepTimes(mesh, dev)

    def make_loop(dims, salt_s):
        """The bounce, compaction and lockstep loop of one lane encoding
        (``dims``) and salt."""

        def bounce(st, step):
            # Below the floor only without ``kernel_tail``: do_steps sends
            # every bounce at or below it there when the render has one.
            if st.pixel.shape[1] >= floor:
                if routes.fused is not None:
                    return routes.fused(hit_scene, cam_rows, st, salt_s, step,
                                        dims, cfg=cfg, lean=lean)
                return P.split_bounce(routes, hit_scene, hit_fn, cam,
                                      cam_rows, st, salt_s, step, dims,
                                      cfg=cfg, lean=lean)
            return P.p_bounce_step(hit_scene, cam, st, salt_s, step, dims,
                                   cfg=cfg, hit_fn=hit_fn, lean=lean)

        def do_steps(st, k, step):
            # At or below the floor kernels B-multi and B (``kernel_tail``)
            # where the render has them, else mk torch bounces at a time;
            # above it, under multi_backend="fused", kernel B's k-bounce.
            # Binned scenes take single steps (a k-bounce would run on stale
            # bins).  Spans and counters go by route, as on one card.
            cur = st.pixel.shape[1]
            if kernel_tail is not None and cur <= floor:
                if k <= 0:
                    return st, step
                with span("persistent.bounce_tail"):
                    st = kernel_tail(st, salt_s, step + 1, k, dims)
                P.count_tail_fused(k)
                return st, step + k
            if bin_box is None and k >= mk:
                multi = None
                if cur <= floor:
                    def multi(st_, s):
                        return P.p_bounce_multi_step(
                            hit_scene, cam, st_, salt_s, s, dims, cfg=cfg,
                            hit_fn=hit_fn, k=mk, lean=lean)
                elif routes.multi is not None:
                    def multi(st_, s):
                        return routes.multi(hit_scene, cam_rows, st_, salt_s,
                                            s, dims, cfg=cfg, k=mk,
                                            lean=lean)
                if multi is not None:
                    tail = cur <= floor
                    with span("persistent.bounce_tail" if tail
                              else "persistent.bounce_kernel"):
                        while k >= mk:
                            st = multi(st, step + 1)
                            (P.count_tail if tail else P.count_kernel)(mk,
                                                                       cur)
                            step += mk
                            k -= mk
            if k <= 0:
                return st, step
            tail = cur < floor
            with span("persistent.bounce_tail" if tail
                      else "persistent.bounce_kernel"):
                for _ in range(k):
                    step += 1
                    if (bin_box is not None
                            and (step - 1) % P._BIN_PERIOD == 0):
                        st = P._bin_sort_core(st, box=bin_box)
                    st = bounce(st, step)
            (P.count_tail if tail else P.count_kernel)(k, cur)
            return st, step

        def compact(st, accum, k_new, tail_sorted=False, split=False):
            profiling.count("persistent.compactions")
            with span("persistent.compact"):
                if use_route:
                    st, accum = P._compact_route(st, accum, k_new=k_new,
                                                 lanes_per_pixel=dims.kpp)
                else:
                    st, accum = P._compact(st, accum, k_new=k_new,
                                           lanes_per_pixel=dims.kpp,
                                           tail_sorted=tail_sorted,
                                           flush=flush_mode)
                return (P._split(st) if split else st), accum

        def one_shot(st, step, max_s):
            with span("persistent.one_shot"):
                return P.p_render_oneshot(hit_scene, cam, st, salt_s, step,
                                          dims, max_s, cfg=cfg,
                                          hit_fn=hit_fn, lean=lean,
                                          tail=kernel_tail)

        def staged_tail(st, accum, step, max_s):
            """Stages of p_render_until per rank, each ending at the alive
            count's halving point; between stages a lockstep compact +
            split sized by the worst rank.  Ranks part within a stage; all
            re-enter at the latest exit step, so no rank repeats a draw."""
            with span("persistent.staged"):
                while step < max_s:
                    cur = st.pixel.shape[1]
                    if cur <= 2 * min_lanes:
                        st = one_shot(st, step, max_s)
                        break
                    target = 1 << (max(cur // 2, 1).bit_length() - 1)
                    st, stp, cnt = P.p_render_until(
                        hit_scene, cam, st, salt_s, step, target, dims,
                        max_s, cfg=cfg, hit_fn=hit_fn, lean=lean,
                        tail=kernel_tail)
                    with span("shard.lockstep"):
                        got = gather_ints([stp, cnt], mesh,
                                          gather=times.gather)    # [D, 2]
                    step, worst = int(got[:, 0].max()), int(got[:, 1].max())
                    if worst == 0 or step >= max_s:
                        break
                    st, accum = compact(st, accum, max(min_lanes,
                                                       P._next_pow2(worst)),
                                        split=True)
                return st, accum

        def run_loop(st, accum, first_check, max_s, state_sorted=False):
            step = 0
            cur = st.pixel.shape[1]
            # A batch that starts at or below the floor never compacts:
            # it runs whole (every rank on its own, no lockstep checks).
            if routes.one_shot == "staged" and cur <= floor:
                return staged_tail(st, accum, 0, max_s)
            if routes.one_shot in ("on", "chunk") and cur <= floor:
                return one_shot(st, 0, max_s), accum
            period = check_period
            last_alive = d * cur
            while step < max_s:
                next_check = (first_check if step < first_check
                              else step + period)
                st, step = do_steps(st, min(next_check, max_s) - step, step)
                cur = st.pixel.shape[1]
                # The counts are read behind a few optimistic bounces:
                # alive only falls, so stale counts are upper bounds.
                pending = _start_counts(st.path_alive, mesh, times.gather)
                ov = 1 if cur >= (1 << 21) else (2 if cur >= (1 << 20) else 4)
                st, step = do_steps(st, min(ov, max_s - step), step)
                with span("persistent.count_read"):
                    counts = pending()
                profiling.count("persistent.alive_at_reads", counts[b])
                profiling.count("persistent.width_at_reads", cur)
                worst = int(counts.max())
                if counts.sum() == 0:
                    break
                if cur < floor:
                    period = max(32, check_period)
                elif worst > 0.9 * last_alive:
                    period = min(period * 2, max(32, check_period))
                else:
                    period = check_period
                last_alive = worst
                if cur <= floor:
                    if routes.one_shot == "staged":
                        return staged_tail(st, accum, step, max_s)
                    k_new = max(min_lanes, P._next_pow2(worst))
                    if k_new <= cur // 2:
                        st, accum = compact(st, accum, k_new, split=True)
                    if routes.one_shot == "on":
                        return one_shot(st, step, max_s), accum
                    continue
                k_new = P._grid_size(worst, min_lanes, cfg.compact_quantum)
                if k_new <= int(cur * shrink):
                    st, accum = compact(st, accum, k_new,
                                        tail_sorted=state_sorted)
            return st, accum

        return do_steps, run_loop

    def respawn(st, dims, salt_s):
        with span("persistent.respawn"):
            return P.p_respawn_step(cam, st, salt_s, 0, dims, cfg=cfg,
                                    lean=lean)

    dims = P.make_dims(cfg, w, h, spp, kpp)
    do_steps, run_loop = make_loop(dims, salt)
    # The rank's lanes are its one chunk.
    with span("persistent.chunk"):
        if adaptive:
            # Phase 1, the prepass: quota 1 on every fresh lane (0 on the
            # wrap pads), max_depth + 1 bounces with no count read; the
            # final depth row, in lane order, is each sample's path length.
            with span("persistent.prepass"):
                st = P.fresh_state(lanes, lanes % kpp,
                                   (quotas > 0).to(torch.int32))
                st = respawn(st, dims, salt)
                st, _ = do_steps(st, cfg.max_depth + 1, 0)
                P._flush(accum, st.pixel[0] // kpp, st.radiance_sum)
            # Phase 2: the rank's remaining samples on lanes allocated by
            # difficulty over its own pixels (wrap pads carry q_rest 0).
            est = st.depth[0].reshape(n_local // kpp, kpp).sum(
                1, dtype=torch.int32)
            pix_ids = lanes[0, ::kpp] // kpp
            q_rest = (quotas[0, ::kpp] > 0).to(torch.int32) * (spp - kpp)
            pix2, s_base2, s_quota2 = alloc_lanes(
                est, n_lanes=n_local, spp_done=kpp, spp=spp,
                kpp_max=cfg.kpp_max, pixel_ids=pix_ids, q_rest=q_rest)
            salt2 = phase2_salt(salt)
            dims2 = P.make_dims(cfg, w, h, spp, 1)
            _, run_loop2 = make_loop(dims2, salt2)
            st = respawn(P.fresh_state(pix2, s_base2, s_quota2), dims2, salt2)
            spp_rest = spp - kpp
            st, accum = run_loop2(st, accum,
                                  spp_rest // min(cfg.kpp_max, spp_rest) + 2,
                                  (spp_rest + 1) * (cfg.max_depth + 2))
            with span("persistent.flush"):
                P._flush(accum, st.pixel[0], st.radiance_sum)
        else:
            st = respawn(P.fresh_state(lanes, (lanes % kpp) * quota, quotas),
                         dims, salt)
            # Each rank's lanes start ascending; binning re-permutes them.
            st, accum = run_loop(
                st, accum, quota + 2, (quota + 1) * (cfg.max_depth + 2),
                state_sorted=(bin_box is None
                              and h_virt * w * kpp < P._SORT_PIX_LIM))
            with span("persistent.flush"):
                P._flush(accum, st.pixel[0] // kpp, st.radiance_sum)

    with span("shard.reduce"):
        total = sum_in_rank_order(all_gather(accum, mesh))
    times.publish(mesh)
    out = P._div(total, spp).T.reshape(h_virt, w, 3)
    return out if cams is None else out.reshape(n_frames, h, w, 3)
