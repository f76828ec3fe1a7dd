"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the hand-written kernels from win32_raytracer_tpu_torch/csrc, holds
each against its plain torch version on the card (on random inputs, and on
the inputs the headline hands it at its own shapes), renders a small image
through both paths, then renders the headline (the RTIOW final scene at
1200x800, 100 spp) through the kernels and checks that both kernels ran.
Each phase prints one line; any failure raises, so the exit code is
non-zero.  The last line is a JSON object naming the device.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 0,1,2  # a subset (0 is always run)

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HEADLINE = dict(width=1200, height=800, samples=100)
HEADLINE_MEAN = 170.1   # the JAX renderer's u8 image mean for this scene and size
HEADLINE_MEAN_TOL = 1.5


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    x = a.astype(np.float64).reshape(-1) - a.mean()
    y = b.astype(np.float64).reshape(-1) - b.mean()
    return float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def compare_hit(rk, rp, what: str) -> tuple:
    """Kernel A's record ``rk`` against the plain one ``rp``, held to phase
    2's bounds; returns (hit-mask, winner disagreement, max |err|)."""
    hit_k, hit_p = rk.hit[0].cpu().numpy(), rp.hit[0].cpu().numpy()
    idx_k, idx_p = rk.idx[0].cpu().numpy(), rp.idx[0].cpu().numpy()
    hit_dis = float((hit_k != hit_p).mean())
    idx_dis = float((idx_k != idx_p).mean())
    agree = (idx_k == idx_p) & hit_k & hit_p
    err, ok = 0.0, True
    for f in ("t", "point", "normal"):
        a = getattr(rk, f).cpu().numpy()[:, agree]
        b = getattr(rp, f).cpu().numpy()[:, agree]
        err = max(err, float(np.abs(a - b).max(initial=0.0)))
        ok &= bool(np.allclose(a, b, rtol=1e-5, atol=1e-5))
    check(hit_dis <= 1e-4, f"kernel A {what}: hit-mask disagreement {hit_dis}")
    check(idx_dis <= 1e-3, f"kernel A {what}: winner disagreement {idx_dis}")
    check(ok, f"kernel A {what}: t/point/normal outside rtol=atol=1e-5")
    return hit_dis, idx_dis, err


def compare_bounce(fk, fp, what: str) -> tuple:
    """Kernel B's state ``fk`` against the plain one ``fp``, held to phase
    3's bounds; returns (alive disagreement, {depth, sample} disagreement
    on agreeing lanes, least close share, max |err|)."""
    al_k = fk.path_alive[0].cpu().numpy()
    al_p = fp.path_alive[0].cpu().numpy()
    al_dis = float((al_k != al_p).mean())
    agree = al_k == al_p
    int_dis = {f: float((getattr(fk, f)[0].cpu().numpy()[agree]
                         != getattr(fp, f)[0].cpu().numpy()[agree]).mean())
               for f in ("depth", "sample")}
    same = agree & (fk.depth[0].cpu().numpy() == fp.depth[0].cpu().numpy())
    close, err = {}, 0.0
    for f in ("origin", "direction", "time", "throughput", "radiance_sum"):
        a = getattr(fk, f).cpu().numpy()[:, same]
        b = getattr(fp, f).cpu().numpy()[:, same]
        close[f] = float(np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=0).mean())
        err = max(err, float(np.abs(a - b).max(initial=0.0)))
    check(al_dis < 0.01, f"kernel B {what}: alive disagreement {al_dis}")
    for f, v in int_dis.items():
        check(v < 0.01, f"kernel B {what}: {f} disagreement {v}")
    for f, v in close.items():
        check(v > 0.99, f"kernel B {what}: {f} close share {v}")
    return al_dis, int_dis, min(close.values()), err


class Smoke:
    def __init__(self, card: str):
        self.card = card
        self.dev = torch.device("cuda")
        self.kernels = {}

    def say(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg}", flush=True)

    # ---- phase 1 ----------------------------------------------------------
    def build(self):
        from win32_raytracer_tpu_torch.kernels import _build
        t0 = time.perf_counter()
        path = _build.build()
        _build.load()
        secs = time.perf_counter() - t0
        ptxas = [ln.strip() for ln in _build.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        self.say("1 build", f"{os.path.basename(path)} in {secs:.2f} s "
                 f"(nvcc {_build.build_seconds:.2f} s); "
                 + " | ".join(ptxas[-4:]))

    # ---- phase 2 ----------------------------------------------------------
    def kernel_a(self):
        from win32_raytracer_tpu_torch.kernels import hit as K
        from win32_raytracer_tpu_torch.ops.hit import sphere_table
        from win32_raytracer_tpu_torch.scene.builders import get_scene

        scene = get_scene("final", device=self.dev)
        table = sphere_table(scene)
        n = 1 << 18
        rng = np.random.default_rng(7)
        o = np.empty((3, n), np.float32)
        # A third from above the ground, a third from the camera region,
        # a third from inside the glass spheres.
        k = n // 3
        o[:, :k] = rng.uniform([-12, 0.01, -12], [12, 4, 12], (k, 3)).T
        o[:, k:2 * k] = (np.array([[15.0], [2.0], [4.0]])
                         + rng.normal(0, 0.3, (3, k)))
        mat_id = scene.mat_id.cpu().numpy()
        glass = np.flatnonzero((mat_id == 2) & scene.active.cpu().numpy())
        pick = rng.choice(glass, n - 2 * k)
        c = scene.center1.cpu().numpy()[pick].T
        r = np.abs(scene.radius.cpu().numpy()[pick])
        off = rng.normal(0, 1, (3, n - 2 * k))
        off *= (0.8 * r * rng.uniform(0, 1, n - 2 * k)) / np.linalg.norm(off, axis=0)
        o[:, 2 * k:] = c + off
        d = rng.normal(0, 1, (3, n)).astype(np.float32)
        tm = rng.uniform(0, 0.05, (1, n)).astype(np.float32)
        o_t, d_t, t_t = (torch.from_numpy(x).to(self.dev) for x in (o, d, tm))

        rk = K.hit_spheres_rows(table, o_t, d_t, t_t)
        rp = K.hit_spheres_rows_plain(table, o_t, d_t, t_t)
        torch.cuda.synchronize()
        hit_dis, idx_dis, err = compare_hit(rk, rp, "random rays")
        self.say("2 kernel A", f"{n} rays vs final scene: hit-mask "
                 f"disagreement {hit_dis:.2e} (<=1e-4), winner disagreement "
                 f"{idx_dis:.2e} (<=1e-3), hits {float(rk.hit.float().mean()):.3f}, "
                 f"max |err| t/point/normal {err:.3e} (rtol=atol=1e-5)")
        self.scene, self.table = scene, table

    # ---- phase 3 ----------------------------------------------------------
    def kernel_b(self):
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import bounce as B
        from win32_raytracer_tpu_torch.persistent import PathState, make_dims
        from win32_raytracer_tpu_torch.scene.camera import default_camera

        # Sizes that are not powers of two, so a reciprocal-multiply in
        # place of a division cannot hide.
        w, h, spp, kpp = 640, 205, 12, 2
        n = 1 << 18
        rng = np.random.default_rng(11)
        dev = self.dev

        def t(x, dt=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev).contiguous()

        st = PathState(
            origin=t(rng.uniform(-12, 12, (3, n))),
            direction=t(rng.normal(0, 1, (3, n))),
            time=t(rng.uniform(0, 0.05, (1, n))),
            throughput=t(rng.uniform(0, 1, (3, n))),
            radiance_sum=t(rng.uniform(0, 1, (3, n))),
            depth=t(np.ones((1, n)), torch.int32),
            sample=t(np.zeros((1, n)), torch.int32),
            pixel=t(np.arange(n)[None], torch.int32),
            path_alive=t(rng.uniform(0, 1, (1, n)) < 0.8, torch.bool),
            s_base=t(np.zeros((1, n)), torch.int32),
            s_quota=t(np.full((1, n), spp // kpp), torch.int32),
        )
        cam_rows = B.pack_camera(default_camera(w, h, device=dev))
        for lean, extra in ((True, {}),
                            (False, dict(russian_roulette=True,
                                         rr_start_depth=1, stratify=True))):
            cfg = RenderConfig(width=w, height=h, samples=spp,
                               lanes_per_pixel=kpp, **extra)
            dims = make_dims(cfg, w, h, spp, kpp)
            args = (self.table, cam_rows, st, 0xABC123, 4, dims)
            fk = B.bounce(*args, cfg=cfg, lean=lean)
            fp = B.bounce_plain(*args, cfg=cfg, lean=lean)
            torch.cuda.synchronize()
            al_dis, int_dis, close, err = compare_bounce(
                fk, fp, f"random state lean={lean}")
            self.say("3 kernel B", f"lean={lean}: {n} random lanes at "
                     f"{w}x{h}, kpp {kpp}: alive disagreement {al_dis:.2e} "
                     f"(<1%), depth/sample {int_dis['depth']:.2e}/"
                     f"{int_dis['sample']:.2e} (<1%), min close share "
                     f"{close:.5f} (>99%), max |err| {err:.3e}")

    # ---- phase 4 ----------------------------------------------------------
    def small_render(self):
        import win32_raytracer_tpu_torch.persistent as P
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig

        base = RenderConfig(width=160, height=120, samples=16, seed=2)
        for label, floor in (("one-shot tail", P._COMPACT_FLOOR),
                             ("compaction, fused bounces", 1 << 14)):
            saved = P._COMPACT_FLOOR
            P._COMPACT_FLOOR = floor
            try:
                rk = render("final", cfg=base, device="cuda")
                rp = render("final", cfg=base.replace(backend="jnp"),
                            device="cuda")
            finally:
                P._COMPACT_FLOOR = saved
            d = float(np.abs(rk.image.astype(float) - rp.image.astype(float)).mean())
            r = pearson(rk.image, rp.image)
            self.say("4 render", f"final 160x120@16 {label}: kernels vs plain "
                     f"mean |diff| {d:.4f} (<=3.0), pearson r {r:.6f} (>=0.98), "
                     f"means {rk.image.mean():.2f}/{rp.image.mean():.2f}, "
                     f"{rk.duration_ms:.0f} ms vs {rp.duration_ms:.0f} ms")
            check(d <= 3.0, f"small render mean diff {d}")
            check(r >= 0.98, f"small render pearson {r}")

    # ---- phase 5 ----------------------------------------------------------
    def headline(self):
        from win32_raytracer_tpu_torch.api import render
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import bounce as B
        from win32_raytracer_tpu_torch.kernels import hit as K

        cfg = RenderConfig(**HEADLINE)
        warm = render("final", cfg=cfg, device="cuda")
        self.say("5 headline", f"warm run {warm.duration_ms / 1e3:.3f} s, "
                 f"mean {warm.image.mean():.3f} [{self.card}]")
        K.LAUNCHES = 0
        B.LAUNCHES = 0
        torch.cuda.synchronize()
        res = render("final", cfg=cfg, device="cuda")
        launches = {"hit": K.LAUNCHES, "bounce": B.LAUNCHES}
        mean = float(res.image.mean())
        wall = res.duration_ms / 1e3
        self.say("5 headline", f"final 1200x800@100 spp: {wall:.4f} s, "
                 f"{res.mrays_per_sec:.3f} Mrays/s, image mean {mean:.3f} "
                 f"(170.1 +- 1.5), launches {launches} [{self.card}]")
        check(res.image.shape == (800, 1200, 3), f"image shape {res.image.shape}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched on the main path: {launches}")
        check(abs(mean - HEADLINE_MEAN) <= HEADLINE_MEAN_TOL,
              f"headline image mean {mean}")
        for name, v in launches.items():
            self.kernels.setdefault(name, {})["launches"] = v

    # ---- kernels at main-path shapes: agreement and times -----------------
    def kernel_main_shapes(self):
        """Holds each kernel against its plain version on inputs the
        headline gives it, then times both.  Kernel B gets the headline
        chunk's first bounce (every lane fresh from the camera) and its
        second (the plain first bounce's output); kernel A gets rays of both,
        in a batch as large as the below-floor tail hands it."""
        from win32_raytracer_tpu_torch.config import RenderConfig
        from win32_raytracer_tpu_torch.kernels import bounce as B
        from win32_raytracer_tpu_torch.kernels import hit as K
        from win32_raytracer_tpu_torch.persistent import (
            _COMPACT_FLOOR, PathState, _grid_size, _resolve_kpp, make_dims,
            p_respawn_step)
        from win32_raytracer_tpu_torch.scene.camera import default_camera

        cfg = RenderConfig(**HEADLINE)
        w, h, spp = cfg.width, cfg.height, cfg.samples
        kpp = _resolve_kpp(cfg, spp)
        n_real = w * h * kpp
        n = _grid_size(n_real, 1 << 12)
        dev = self.dev
        i32 = dict(dtype=torch.int32, device=dev)
        direction = torch.zeros((3, n), device=dev)
        direction[2] = 1.0
        sq = torch.full((1, n), spp // kpp, **i32)
        sq[:, n_real:] = 0
        st = PathState(
            origin=torch.zeros((3, n), device=dev), direction=direction,
            time=torch.zeros((1, n), device=dev),
            throughput=torch.ones((3, n), device=dev),
            radiance_sum=torch.zeros((3, n), device=dev),
            depth=torch.zeros((1, n), **i32),
            sample=torch.full((1, n), -1, **i32),
            pixel=torch.arange(n, **i32).clamp_max(n_real - 1)[None],
            path_alive=torch.zeros((1, n), dtype=torch.bool, device=dev),
            s_base=(torch.arange(n, **i32) % kpp * (spp // kpp))[None],
            s_quota=sq)
        cam = default_camera(w, h, device=dev)
        dims = make_dims(cfg, w, h, spp, kpp)
        st = p_respawn_step(cam, st, 12345, 0, dims, cfg=cfg, lean=True)
        cam_rows = B.pack_camera(cam)
        m = _COMPACT_FLOOR  # the largest batch the below-floor hit sees
        # Lanes spread evenly over the image, as a compacted tail batch is.
        pick = torch.linspace(0, n_real - 1, m, device=dev).long()

        errs = {"hit": 0.0, "bounce": 0.0}
        state = st
        for step in (1, 2):
            args = (self.table, cam_rows, state, 12345, step, dims)
            fk = B.bounce(*args, cfg=cfg, lean=True)
            fp = B.bounce_plain(*args, cfg=cfg, lean=True)
            torch.cuda.synchronize()
            al_dis, int_dis, close, err = compare_bounce(
                fk, fp, f"headline bounce {step}")
            errs["bounce"] = max(errs["bounce"], err)
            o, d, tm = (x[:, pick].contiguous()
                        for x in (state.origin, state.direction, state.time))
            rk = K.hit_spheres_rows(self.table, o, d, tm)
            rp = K.hit_spheres_rows_plain(self.table, o, d, tm)
            torch.cuda.synchronize()
            hit_dis, idx_dis, herr = compare_hit(rk, rp, f"headline rays {step}")
            errs["hit"] = max(errs["hit"], herr)
            self.say("main shapes", f"bounce {step} at {n} lanes "
                     f"({w}x{h}, kpp {kpp}, lean): alive disagreement "
                     f"{al_dis:.2e}, depth/sample {int_dis['depth']:.2e}/"
                     f"{int_dis['sample']:.2e}, min close share {close:.5f}, "
                     f"max |err| {err:.3e}; hit on {m} of its rays: "
                     f"hit-mask {hit_dis:.2e}, winner {idx_dis:.2e}, max "
                     f"|err| {herr:.3e}, hits {float(rp.hit.float().mean()):.3f}")
            state = PathState(*(x.contiguous() for x in fp))
        del fk, fp, rk, rp, state

        args = (self.table, cam_rows, st, 12345, 1, dims)
        o, d, tm = (x[:, pick].contiguous() for x in (st.origin, st.direction, st.time))
        times = {
            "bounce": (cuda_ms(lambda: B.bounce(*args, cfg=cfg, lean=True), 10),
                       cuda_ms(lambda: B.bounce_plain(*args, cfg=cfg, lean=True), 2)),
            "hit": (cuda_ms(lambda: K.hit_spheres_rows(self.table, o, d, tm), 10),
                    cuda_ms(lambda: K.hit_spheres_rows_plain(self.table, o, d, tm), 3)),
        }
        for name, (ms, plain) in times.items():
            self.kernels.setdefault(name, {}).update(
                ms=ms, plain_ms=plain, max_abs_err=errs[name])
        self.say("times", f"bounce at {n} lanes: kernel {times['bounce'][0]:.3f} ms, "
                 f"plain {times['bounce'][1]:.3f} ms; hit at {m} rays: kernel "
                 f"{times['hit'][0]:.3f} ms, plain {times['hit'][1]:.3f} ms "
                 f"[{self.card}]")


KERNEL_META = {
    "hit": ("sphere_hit", "win32_raytracer_tpu_torch/csrc/hit.cu",
            "win32_raytracer_tpu/kernels/hit_pallas_v6.py:181"),
    "bounce": ("fused_bounce", "win32_raytracer_tpu_torch/csrc/bounce.cu",
               "win32_raytracer_tpu/kernels/bounce_pallas.py:38"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5",
                    help="comma-separated phases to run (0 always runs)")
    phases = {int(p) for p in ap.parse_args().phases.split(",")}

    # ---- phase 0 ----
    if not torch.cuda.is_available():
        print("[0 device] torch.cuda.is_available() is False: this needs a "
              "CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    print(f"[0 device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    import win32_raytracer_tpu_torch  # noqa: F401  (fails outside the repo)

    smoke = Smoke(card)
    if 1 in phases or phases & {2, 3, 4, 5}:
        smoke.build()
    if phases & {2, 3, 5}:
        smoke.kernel_a()
    if 3 in phases:
        smoke.kernel_b()
    if 4 in phases:
        smoke.small_render()
    if 5 in phases:
        smoke.headline()
        smoke.kernel_main_shapes()
        kernels = []
        for key, (name, src, replaces) in KERNEL_META.items():
            k = smoke.kernels[key]
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces, "launches": k["launches"],
                            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                            "plain_ms": k["plain_ms"]})
        print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
