"""Command-line interface (``win32_raytracer_tpu.cli``).

    python -m win32_raytracer_tpu_torch.cli [width height] [samples] [devices] [perfTest] [flags]

A superset of the reference exe's positional CLI (Main.cpp:73-119: width
and height, samples, threads, perfTest; defaults 640x480 at 50 spp), with
the same parser as the JAX package's: positionals, flags, defaults and
choices, and flags for what the reference hard-coded (scene
RayTracer.cpp:969, seed, output path pch.h:183, depth pch.h:173).

The render runs on the CUDA card; ``--platform cpu`` renders on the CPU
(the kernels' plain versions), and without either a missing card raises.
``perfTest`` (or ``--perf-test``) writes the elapsed ms to the perf file
and exits (Game.cpp:187-191, 222-228), with a JSON line of Mrays/s on
stdout.  ``--checkpoint FILE`` renders in ``--passes`` resumable passes
(utils/checkpoint.py; run the command again to resume).  ``devices`` > 1
is not ported yet and raises ``NotImplementedError`` naming its ROADMAP
item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .config import (DEFAULT_IMAGE_HEIGHT, DEFAULT_IMAGE_WIDTH,
                     DEFAULT_NUM_SAMPLES, MAX_RECURSION, RenderConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wrt-render",
        description="PyTorch/CUDA path tracer with the capabilities of "
                    "jamesmcgill/win32-raytracer",
    )
    p.add_argument("width", nargs="?", type=int, default=DEFAULT_IMAGE_WIDTH)
    p.add_argument("height", nargs="?", type=int, default=DEFAULT_IMAGE_HEIGHT)
    p.add_argument("samples", nargs="?", type=int, default=DEFAULT_NUM_SAMPLES)
    p.add_argument("devices", nargs="?", type=int, default=0,
                   help="devices (0 = one device; the reference's 'threads' "
                        "slot; more than one is not ported yet)")
    p.add_argument("perf", nargs="?", default="",
                   help="literal 'perfTest' for perf-harness mode "
                        "(Main.cpp:112-118)")
    p.add_argument("--scene", default="random",
                   help="test | random | final | mesh | mesh20k (default: "
                        "random, like the reference; see "
                        "scene.builders.SCENES)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--depth", type=int, default=MAX_RECURSION)
    p.add_argument("--out", default="out.bmp",
                   help="output image (.bmp/.png/.ppm; default out.bmp like "
                        "the reference)")
    p.add_argument("--backend", default="auto", choices=["auto", "pallas", "jnp"],
                   help="hit functions: auto/pallas = the CUDA kernels (their "
                        "plain versions on the CPU), jnp = the plain torch ops")
    p.add_argument("--scatter-backend", default="auto",
                   choices=["auto", "pallas", "jnp"],
                   help="persistent scheduler scatter+respawn step backend")
    p.add_argument("--hit-kernel", default="auto",
                   choices=["auto", "v4", "v6", "v7"],
                   help="persistent scheduler sphere-hit route (see "
                        "RenderConfig)")
    p.add_argument("--fuse-bounce", default="auto",
                   choices=["auto", "on", "off"],
                   help="single-kernel fused bounce (RenderConfig.fuse_bounce)")
    p.add_argument("--accel", default="auto", choices=["auto", "grid", "off"],
                   help="acceleration structure (see RenderConfig.accel)")
    p.add_argument("--ray-binning", default="auto",
                   choices=["auto", "on", "off"],
                   help="per-bounce spatial lane sort for grid-"
                        "accelerated scenes (RenderConfig.ray_binning)")
    p.add_argument("--redistribute", default="auto",
                   choices=["auto", "on", "off"],
                   help="adopt donors' unstarted samples on spare lanes "
                        "at compaction (RenderConfig.redistribute)")
    p.add_argument("--scheduler", default="auto",
                   choices=["auto", "wavefront", "persistent"])
    p.add_argument("--lanes-per-pixel", type=int, default=0,
                   help="persistent scheduler: replica lanes per pixel "
                        "(0 = auto; must divide samples)")
    p.add_argument("--one-shot", default="auto",
                   choices=["auto", "on", "off", "staged"],
                   help="persistent scheduler: chunks at or below the "
                        "compaction floor run whole (RenderConfig.one_shot)")
    p.add_argument("--multi-k", type=int, default=0,
                   help="bounces per below-floor multi-step (persistent "
                        "scheduler; 0 = auto, RenderConfig.multi_k)")
    p.add_argument("--compact-quantum", type=int, default=0,
                   help="compaction size-grid quantum in lanes (persistent "
                        "scheduler; 0 = the mantissa grid, "
                        "RenderConfig.compact_quantum)")
    p.add_argument("--compact-shrink", type=float, default=0.0,
                   help="above-floor compaction trigger: compact when "
                        "the next grid size is <= this fraction of the "
                        "current batch (persistent scheduler; 0 = auto, "
                        "RenderConfig.compact_shrink)")
    p.add_argument("--compactor", default="",
                   choices=["", "sort", "route"],
                   help="compaction engine (RenderConfig.compactor; "
                        "'' = auto)")
    p.add_argument("--multi-backend", default="",
                   choices=["", "xla", "fused"],
                   help="below-floor multi-bounce engine: torch steps vs "
                        "the k-bounce kernel (RenderConfig.multi_backend; "
                        "'' = auto)")
    p.add_argument("--hit-terms", type=int, default=0,
                   help="accepted and ignored (the reference's split-bf16 "
                        "limb count; RenderConfig.hit_terms)")
    p.add_argument("--tri-gather", default="auto",
                   choices=["auto", "fused", "deferred"],
                   help="triangle-grid winner-attribute path "
                        "(RenderConfig.tri_gather)")
    p.add_argument("--adaptive", default="off", choices=["off", "on"],
                   help="difficulty-adaptive lane allocation: a quota-1 "
                        "prepass measures per-pixel path length, then the "
                        "remaining samples run on difficulty-proportional "
                        "lanes (RenderConfig.adaptive_alloc; persistent "
                        "scheduler, lanes_per_pixel > 1)")
    p.add_argument("--stratify", action="store_true",
                   help="stratified pixel jitter (variance reduction)")
    p.add_argument("--shard-mode", default="persistent",
                   choices=["rows", "spp", "persistent"])
    p.add_argument("--perf-test", action="store_true")
    p.add_argument("--perf-file", default="perf.txt",
                   help="timing file written in perf mode (Game.cpp:187-191)")
    p.add_argument("--animate", type=int, default=0, metavar="N",
                   help="render an N-frame orbit flythrough; --out becomes "
                        "the frame pattern")
    p.add_argument("--orbit-radius", type=float, default=16.0,
                   help="camera orbit radius for --animate")
    p.add_argument("--batch-frames", type=int, default=0,
                   help="frames per persistent batch for --animate "
                        "(0 = auto)")
    p.add_argument("--resume", action="store_true",
                   help="with --animate: skip batches whose frame files "
                        "already exist")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint file for resumable rendering")
    p.add_argument("--passes", type=int, default=10,
                   help="resumable passes for --checkpoint (must divide "
                        "samples)")
    p.add_argument("--russian-roulette", action="store_true",
                   help="enable RR path termination (extension; the "
                        "reference never terminates diffuse paths early)")
    p.add_argument("--textbook", action="store_true",
                   help="textbook refract/schlick instead of the "
                        "reference's quirks (RayTracer.cpp:168, 658)")
    p.add_argument("--platform", default="",
                   help="'cpu' renders on the CPU; empty (or 'cuda') on the "
                        "CUDA card")
    p.add_argument("--quiet", action="store_true")
    return p


def _device(platform: str):
    """The ``device=`` of ``--platform``: None (the card) or "cpu"."""
    if platform in ("", "cuda"):
        return None
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"unknown --platform {platform!r} (cpu | cuda)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    perf_mode = args.perf_test or args.perf == "perfTest"

    from .api import render, resolve_device
    device = resolve_device(_device(args.platform))

    cfg = RenderConfig(
        width=args.width, height=args.height, samples=args.samples,
        max_depth=args.depth, seed=args.seed, backend=args.backend,
        scatter_backend=args.scatter_backend,
        hit_kernel=args.hit_kernel, fuse_bounce=args.fuse_bounce,
        accel=args.accel, ray_binning=args.ray_binning,
        redistribute=args.redistribute,
        scheduler=args.scheduler,
        lanes_per_pixel=args.lanes_per_pixel, stratify=args.stratify,
        adaptive_alloc=args.adaptive,
        one_shot=args.one_shot,
        multi_k=args.multi_k,
        compactor=args.compactor,
        multi_backend=args.multi_backend,
        hit_terms=args.hit_terms,
        compact_quantum=args.compact_quantum,
        compact_shrink=args.compact_shrink,
        tri_gather=args.tri_gather,
        russian_roulette=args.russian_roulette,
    )
    if args.textbook:
        cfg = cfg.replace(refract_discriminant_bias=1.0,
                          schlick_uses_ni_over_nt=False)

    def log(msg):
        if not args.quiet:
            print(msg, file=sys.stderr, flush=True)

    log(f"scene={args.scene} {cfg.width}x{cfg.height} spp={cfg.samples} "
        f"depth={cfg.max_depth} seed={cfg.seed} backend={cfg.backend}")

    if args.devices and args.devices > 1:
        raise NotImplementedError(
            f"rendering on {args.devices} devices is not ported yet: ROADMAP "
            "Queue 1 item 11 (multi-device)")

    if args.animate and args.checkpoint:
        log("--animate and --checkpoint are mutually exclusive; use "
            "--resume to resume a flythrough at frame granularity")
        return 2

    if args.animate:
        from .animation import orbit_path, render_animation
        from .scene.builders import get_scene
        try:  # --out may already be a frame pattern ("frames/f_%03d.png")
            args.out % 0
            pattern = args.out
        except TypeError:
            root, ext = os.path.splitext(args.out)
            pattern = f"{root}_%04d{ext or '.png'}"
        cams = orbit_path(n_frames=args.animate, radius=args.orbit_radius,
                          aspect_ratio=cfg.width / cfg.height)
        if perf_mode and args.resume:
            # Perf mode measures renders; read-backs would report decode
            # throughput.
            log("perf mode ignores --resume (it must measure renders)")
            args.resume = False
        resumed = []  # resumed read-backs report ms == 0.0
        t0 = time.perf_counter()
        frames = render_animation(
            get_scene(args.scene), cams, cfg, out_pattern=pattern,
            batch_frames=args.batch_frames, resume=args.resume,
            frame_callback=(lambda i, img, ms:
                            resumed.append(i) if ms == 0.0 else None),
            device=device)
        dt = time.perf_counter() - t0
        # fps counts rendered frames only.
        rendered = len(frames) - len(resumed)
        fps = rendered / dt if rendered else 0.0
        log(f"{len(frames)} frames ({rendered} rendered, "
            f"{len(resumed)} resumed) in {dt:.2f}s = {fps:.2f} fps "
            f"({cfg.width * cfg.height * cfg.samples * rendered / dt / 1e6:.1f}"
            " Mrays/s primary)")
        log(f"wrote {pattern % 0} .. {pattern % (len(frames) - 1)}")
        if perf_mode:
            with open(args.perf_file, "w") as f:
                f.write(f"{dt * 1e3:.0f}\n")
            print(json.dumps({
                "metric": "flythrough fps",
                "value": round(fps, 3), "unit": "fps",
                "wall_ms": round(dt * 1e3, 1),
                "resumed_frames": len(resumed),
                "config": f"{cfg.width}x{cfg.height}@{cfg.samples}spp "
                          f"x{len(frames)} frames scene={args.scene}",
            }))
        return 0

    if args.checkpoint:
        # A resumable render (utils/checkpoint.py): rerun the same command
        # to resume from the file.
        from .api import RenderResult
        from .scene.builders import get_scene
        from .utils.checkpoint import load_checkpoint, render_with_checkpoints
        prior = load_checkpoint(args.checkpoint)
        passes_before = prior[1] if prior is not None else 0
        t0 = time.perf_counter()
        img = render_with_checkpoints(get_scene(args.scene), None, cfg,
                                      args.checkpoint, passes=args.passes,
                                      device=device)
        dur = (time.perf_counter() - t0) * 1e3
        if img is None:
            log("checkpoint budget exhausted; rerun to resume")
            return 0
        # Throughput counts only the passes this run rendered.
        rendered_passes = max(0, args.passes - passes_before)
        rays = (cfg.width * cfg.height * cfg.samples
                * rendered_passes / args.passes)
        if passes_before:
            log(f"resumed at pass {passes_before}/{args.passes}; "
                f"throughput counts {rendered_passes} rendered pass(es)")
        result = RenderResult(image=img, duration_ms=dur, config=cfg,
                              mrays_per_sec=rays / (dur / 1e3) / 1e6,
                              device=str(device))
    else:
        result = render(args.scene, cfg=cfg, shard_mode=args.shard_mode,
                        device=device)
    log(f"render duration: {result.duration_ms:.0f} ms "
        f"({result.mrays_per_sec:.2f} Mrays/s primary)")

    if perf_mode:
        # Reference behaviour: elapsed ms to the perf file, then exit
        # (Game.cpp:187-191), plus a JSON line on stdout for harnesses.
        with open(args.perf_file, "w") as f:
            f.write(f"{result.duration_ms:.0f}\n")
        print(json.dumps({
            "metric": "Mrays/sec primary",
            "value": round(result.mrays_per_sec, 4),
            "unit": "Mrays/s",
            "wall_ms": round(result.duration_ms, 1),
            "config": f"{cfg.width}x{cfg.height}@{cfg.samples}spp "
                      f"scene={args.scene}",
        }))
        return 0

    from .io.image import write_image
    write_image(args.out, result.image)
    log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
