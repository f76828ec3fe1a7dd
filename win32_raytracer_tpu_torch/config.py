"""Render configuration (PyTorch port).

The same immutable dataclass as ``win32_raytracer_tpu.config``: every field
and default is kept so a config can be handed to either package (a test
holds the two field lists equal).  The one field with no counterpart here,
``pallas_interpret``, is accepted; the persistent scheduler raises
``NotImplementedError`` when it is set (``persistent.check_supported``).
"""

from __future__ import annotations

import dataclasses

# Reference defaults (pch.h:170-174).
DEFAULT_IMAGE_WIDTH = 640
DEFAULT_IMAGE_HEIGHT = 480
DEFAULT_NUM_SAMPLES = 50
MAX_RECURSION = 10
DEFAULT_IMAGE_FILENAME = "out.bmp"  # pch.h:183

# Numerical constants of the tracer core.
EPSILON = 1e-5          # normal offset, RayTracer.cpp:13
MIN_HIT_T = 0.001       # near-t threshold, RayTracer.cpp:430
REFLECT_THRES = 0.05    # dielectric reflect bias, RayTracer.cpp:661
SHUTTER_OPEN_T = 0.0    # camera defaults, RayTracer.cpp:233-234
SHUTTER_CLOSE_T = 0.05


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Renderer parameters.

    ``refract_discriminant_bias``, ``schlick_uses_ni_over_nt`` and
    ``reflect_thres`` reproduce the reference's numerical quirks
    (RayTracer.cpp:168, 658, 661-662); the defaults are the reference's.
    """

    width: int = DEFAULT_IMAGE_WIDTH
    height: int = DEFAULT_IMAGE_HEIGHT
    samples: int = DEFAULT_NUM_SAMPLES
    max_depth: int = MAX_RECURSION  # depth > max_depth returns black
    seed: int = 0

    # Quirk toggles (defaults = reference behavior).
    refract_discriminant_bias: float = 2.0
    schlick_uses_ni_over_nt: bool = True
    reflect_thres: float = REFLECT_THRES

    # Numerics.
    epsilon: float = EPSILON
    min_hit_t: float = MIN_HIT_T

    # Every uniform draw becomes 0.5 (wavefront scheduler only).
    deterministic: bool = False

    # Optional Russian-roulette path termination (extension).
    russian_roulette: bool = False
    rr_start_depth: int = 3

    # Hit backend: "auto" = the hand kernels (their plain versions for
    # tensors on the CPU); "pallas" = the hand kernels, CUDA only; "jnp" =
    # the plain torch ops on any device (the kernels' reference).
    backend: str = "auto"
    # Bounce routes of the persistent scheduler (persistent.resolve_routes):
    # scatter "pallas" = the scatter + respawn kernel; hit_kernel "v4"/"v6"
    # = the sphere-hit kernel plus the torch scatter above the floor;
    # fuse_bounce "off" = the split bounce (hit + sky kernel, then scatter).
    scatter_backend: str = "auto"   # "auto" | "pallas" | "jnp"
    hit_kernel: str = "auto"        # "auto" | "v4" | "v6" | "v7"
    fuse_bounce: str = "auto"       # "auto" | "on" | "off"
    # Acceleration: the sphere grid and the triangle grid; ray binning.
    accel: str = "auto"             # "auto" | "grid" | "off"
    ray_binning: str = "auto"       # "auto" | "on" | "off"
    redistribute: str = "auto"      # "auto" | "on" | "off"
    # Triangle-grid knobs (triangle scenes only).  tri_sub_gate changes no
    # result here (kernel D gates per CTA of 32 lanes); tri_rebin "on" and
    # "dda" sort the triangle pass's working set (kernels/tri_rebin.py,
    # kernels/tri_dda.py; tri_dda_k pairs a lane, 0 = 4).
    tri_tile_rows: int = 0
    tri_ray_block: int = 0
    tri_early_exit: str = "auto"    # "auto" | "on" | "off"
    tri_any_skip: str = "auto"      # "auto" | "on" | "off"
    tri_sub_gate: int = 0
    tri_gather: str = "auto"        # "auto" | "fused" | "deferred"
    tri_partition: str = "auto"     # "auto" | "morton" | "median"
    tri_rebin: str = "auto"         # "auto" | "on" | "dda" | "off"
    tri_dda_k: int = 0
    # Lanes in flight per chunk.
    rays_per_chunk: int = 1 << 22

    # "wavefront" | "persistent" | "auto" (persistent when samples >= 8).
    scheduler: str = "auto"
    # Persistent scheduler: steps between alive checks (0 = auto).
    check_period: int = 0
    # "auto" = chunks that start at/below the compaction floor run whole
    # without alive checks; "off" = always the checked host loop.
    one_shot: str = "auto"  # "auto" | "on" | "off" | "staged"
    # Bounces per below-floor multi-step (0 = auto, 4).
    multi_k: int = 0
    # "fused": below the floor, k bounces in one launch of the fused kernel.
    multi_backend: str = ""         # "" (= "xla") | "xla" | "fused"
    # Split-bf16 limb count of the TPU hit; accepted and ignored (the
    # port's sweep is exact f32).
    hit_terms: int = 0
    # Compaction: absolute size quantum (0 = mantissa grid), shrink
    # trigger (0.0 = 0.90), engine and dropped-tail flush.
    compact_quantum: int = 0
    compact_shrink: float = 0.0
    compactor: str = ""             # "" (= "sort") | "sort" | "route"
    flush_mode: str = ""            # "" (= "scatter") | "scatter" | "window"
    # Replica lanes per pixel (0 = auto: largest of 8/4/2 with quota >= 4).
    lanes_per_pixel: int = 0
    # Difficulty-adaptive lane allocation (adaptive.py): a quota-1 prepass,
    # then the remaining samples on lanes allocated by path length; pool
    # "on" = max(raw, 3x3 box mean)^1.2 of the estimate; kpp_max caps the
    # lanes a pixel takes (softly).
    adaptive_alloc: str = "off"     # "off" | "on"
    adaptive_pool: str = "auto"     # "auto" | "on" | "off"
    kpp_max: int = 32

    # Stratified pixel jitter on a kx*ky grid (extension).
    stratify: bool = False

    # Pallas interpret mode of the reference's CI; no counterpart here.
    pallas_interpret: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def resolve_scheduler(cfg: RenderConfig, samples: int | None = None) -> str:
    """The scheduler "auto" rule: persistent at >= 8 samples unless the
    render is deterministic."""
    if cfg.scheduler != "auto":
        return cfg.scheduler
    spp = cfg.samples if samples is None else samples
    return ("persistent"
            if spp >= 8 and not cfg.deterministic else "wavefront")
