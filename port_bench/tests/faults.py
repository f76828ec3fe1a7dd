"""Faults planted in the port underneath a run (``run.main(plant=...)``),
for the test that sees ``correct`` come out false for each."""

from __future__ import annotations


def _wrap_persistent(change):
    import importlib
    persistent = importlib.import_module("win32_raytracer_tpu_torch.persistent")
    orig = persistent.render_image_persistent

    def render_image_persistent(scene, cam, cfg, *args, **kw):
        return change(orig, scene, cam, cfg, *args, **kw)

    persistent.render_image_persistent = render_image_persistent


def state_unchanged():
    """Every render returns its accumulator as it started (black)."""
    _wrap_persistent(lambda f, s, c, cfg, *a, **k: f(s, c, cfg, *a, **k) * 0.0)


def half_batch():
    """Half of each pixel's samples left out, the mean taken over the rest."""
    _wrap_persistent(lambda f, s, c, cfg, *a, **k: f(
        s, c, cfg.replace(samples=max(1, cfg.samples // 2)), *a, **k))


def answer_altered():
    """An 8 x 8 patch of every image turned white where it is made."""
    import importlib
    render = importlib.import_module("win32_raytracer_tpu_torch.render")
    orig = render.tonemap

    def tonemap(linear):
        out = orig(linear).clone()
        out[..., :8, :8, :] = 255
        return out

    render.tonemap = tonemap


def exchange_left_out():
    """The sharded render's image reduce keeps this rank's part only."""
    import torch.distributed as dist
    from win32_raytracer_tpu_torch.parallel import persistent_shard
    persistent_shard.sum_in_rank_order = lambda parts: parts[dist.get_rank()]
