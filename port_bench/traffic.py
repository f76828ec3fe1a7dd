"""The one traffic generator: a cell's ``traffic`` parameters and a run's
``--seed`` give every call of the window its render seed and cameras.

Parameters (``workloads/<cell>.json``, key ``params``):

* ``entry``: ``"render"`` (``api.render``, one camera a call) or
  ``"animation"`` (``animation.render_animation``, ``frames`` cameras a
  call);
* ``width``, ``height``, ``spp`` (optional): the call's size where it is
  not the config's (a preview of the same deployment);
* ``camera``: ``{"path": "fixed"}`` (the reference's view) or
  ``{"path": "orbit", "radius", "height", "step_deg", "frame_step_deg"}``:
  call i looks from the angle a0 + i * step_deg on the orbit, frame k of
  a call from a further k * frame_step_deg; a0 is drawn from the seed;
* ``frames``: cameras a call (1 for ``render``).

Render seeds are distinct within a run: (base + i * 0x9E3779B1) mod 2^31
for call i, base drawn from the seed; the warm-up takes call -1's.
"""

from __future__ import annotations

import math

import numpy as np

from .scenes import camera as camera_mod

_STEP = 0x9E3779B1   # odd, so i -> seed is one to one mod 2^31
_MOD = 1 << 31


class Traffic:
    def __init__(self, params: dict, config: dict, seed: int):
        self.entry = params["entry"]
        self.width = int(params.get("width", config["width"]))
        self.height = int(params.get("height", config["height"]))
        self.spp = int(params.get("spp", config["spp"]))
        self.max_depth = int(config["max_depth"])
        self.frames = int(params.get("frames", 1))
        self.camera = params["camera"]
        ss = np.random.SeedSequence(int(seed) & ((1 << 64) - 1))
        base, angle = ss.generate_state(2, np.uint64)
        self.base = int(base) % _MOD
        self.angle0 = float(angle) / 2.0 ** 64 * 2.0 * math.pi

    @property
    def rays_per_call(self) -> int:
        return self.width * self.height * self.spp * self.frames

    def seed(self, i: int) -> int:
        return (self.base + i * _STEP) % _MOD

    def cameras(self, i: int) -> list:
        """Camera dicts of call ``i`` (``scenes/camera.py``)."""
        aspect = self.width / self.height
        cam = self.camera
        if cam["path"] == "fixed":
            return [camera_mod.reference_view(aspect)] * self.frames
        if cam["path"] != "orbit":
            raise ValueError(f"unknown camera path {cam['path']!r}")
        a = self.angle0 + math.radians(cam["step_deg"]) * i
        step = math.radians(cam.get("frame_step_deg", 0.0))
        return [camera_mod.orbit_view(a + k * step, aspect, cam["radius"],
                                      cam["height"])
                for k in range(self.frames)]
