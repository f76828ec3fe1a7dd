"""PyTorch port: multi-frame batches, ``animation.py`` and
``io/image.read_image`` against the JAX package.

Kernel B and F's camera selection per lane (one camera per frame of a
tall virtual image) is held against the plain respawn on the card by
chip_smoke.py phases 9-10, and BASELINE config 5 runs there in phase 12."""

import struct
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.animation import _auto_batch_frames as jax_abf
from win32_raytracer_tpu.animation import orbit_path as jax_orbit
from win32_raytracer_tpu.animation import render_animation as jax_animation
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.io.image import read_image as jax_read_image
from win32_raytracer_tpu.scene.builders import get_scene as jax_get_scene
from win32_raytracer_tpu.scene.camera import Camera as JCamera
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.animation import (
    _auto_batch_frames, orbit_path, render_animation)
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.io.image import read_image, write_image
from win32_raytracer_tpu_torch.kernels import bounce as B
from win32_raytracer_tpu_torch.scene.builders import get_scene

torch.set_num_threads(1)


def _stats(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    return float(np.abs(a - b).mean()), r


@pytest.mark.parametrize("kw", [
    dict(n_frames=5, aspect_ratio=4 / 3),
    dict(look_to=(0.5, 0.2, -1.0), radius=9.0, height=3.5, n_frames=3,
         vfov_degrees=35.0, aspect_ratio=1.5, aperture=0.0,
         start_angle=0.7, sweep=1.2),
])
def test_orbit_path_matches_reference(kw):
    ours, ref = orbit_path(**kw), jax_orbit(**kw)
    assert len(ours) == len(ref) == kw["n_frames"]
    for a, b in zip(ours, ref):
        for f in JCamera._fields:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)), err_msg=f)


def test_resolve_kpp_and_auto_batch_frames_match_reference():
    for w, h in ((640, 480), (160, 120), (1920, 1080), (48, 32), (7, 5)):
        for spp in (1, 6, 8, 16, 32, 100):
            for kpp in (0, 1, 2, 4):
                for rays in (1 << 22, 1 << 18, 1 << 25):
                    kw = dict(width=w, height=h, samples=spp,
                              lanes_per_pixel=kpp, rays_per_chunk=rays)
                    for frames in (0, 1, 2, 3, 8, 64):
                        try:
                            ref = (JP._resolve_kpp(JC(**kw), spp, frames, w * h),
                                   jax_abf(JC(**kw), frames))
                        except ValueError:
                            with pytest.raises(ValueError):
                                TP._resolve_kpp(TC(**kw), spp, frames, w * h)
                            continue
                        assert (TP._resolve_kpp(TC(**kw), spp, frames, w * h),
                                _auto_batch_frames(TC(**kw), frames)) == ref, kw


@pytest.mark.parametrize("lean", [True, False])
def test_respawn_core_three_frames_matches_reference(lean):
    """Every lane dead and due a sample, its pixel id spanning three frames:
    the integer rows exactly, the rays to f32 round-off (XLA's CPU fuses
    the lens offset's multiply and add; ROADMAP Queue 3).  The state rows
    stay contiguous, as the kernels take them."""
    w, h, spp, kpp, frames = 24, 16, 8, 2, 3
    kw = dict(width=w, height=h, samples=spp, lanes_per_pixel=kpp,
              **({} if lean else dict(stratify=True)))
    n = frames * w * h * kpp
    rng = np.random.default_rng(3)
    arrs = dict(
        origin=rng.normal(0, 1, (3, n)).astype(np.float32),
        direction=rng.normal(0, 1, (3, n)).astype(np.float32),
        time=rng.uniform(0, 1, (1, n)).astype(np.float32),
        throughput=rng.uniform(0, 1, (3, n)).astype(np.float32),
        radiance_sum=rng.uniform(0, 1, (3, n)).astype(np.float32),
        depth=rng.integers(0, 5, (1, n)).astype(np.int32),
        sample=rng.integers(-1, 3, (1, n)).astype(np.int32),
        pixel=np.arange(n, dtype=np.int32)[None],
        path_alive=rng.uniform(0, 1, (1, n)) < 0.3,
        s_base=(np.arange(n, dtype=np.int32) % kpp * (spp // kpp))[None],
        s_quota=np.full((1, n), spp // kpp, np.int32),
    )
    jcams = jax_orbit(n_frames=frames, aspect_ratio=w / h)
    cam_x = JCamera(*(jnp.stack([jnp.asarray(getattr(c, f), jnp.float32)
                                 for c in jcams]) for f in JCamera._fields))
    ref = JP._respawn_core(cam_x, JP.PathState(**{k: jnp.asarray(v)
                                                   for k, v in arrs.items()}),
                           np.uint32(99), jnp.int32(7),
                           JP.make_dims(JC(**kw), w, h, spp, kpp),
                           cfg=JP.step_cfg(JC(**kw)), n_frames=frames,
                           lean=lean)
    ours = TP._respawn_core(
        B.unpack_camera(B.pack_cameras(orbit_path(n_frames=frames,
                                                  aspect_ratio=w / h))),
        TP.PathState(**{k: torch.from_numpy(v.copy()) for k, v in arrs.items()}),
        99, 7, TP.make_dims(TC(**kw), w, h, spp, kpp), cfg=TC(**kw), lean=lean)
    for f in TP.PathState._fields:
        a, b = getattr(ours, f), np.asarray(getattr(ref, f))
        assert a.is_contiguous(), f
        if a.dtype in (torch.int32, torch.bool):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6,
                                       err_msg=f)
    # Every frame's camera was used.
    started = ~arrs["path_alive"][0] & (arrs["sample"][0] < spp // kpp - 1)
    assert started[: n // 3].any() and started[-n // 3:].any()


def test_singleton_camera_list_is_the_plain_camera():
    """A list of one camera renders as that camera, [1, H, W, 3]."""
    cfg = TC(width=24, height=16, samples=8, seed=5)
    cams = orbit_path(n_frames=2, aspect_ratio=1.5)
    scene = get_scene("test")
    one = TP.render_image_persistent(scene, cams[:1], cfg)
    plain = TP.render_image_persistent(scene, cams[0], cfg)
    assert one.shape == (1, 16, 24, 3) and plain.shape == (16, 24, 3)
    assert torch.equal(one[0], plain)


# Batched against unbatched frames draw other seeds (but frame 0's):
# measured mean |diff| <= 7.82 and r >= 0.9766 (final scene, 48x32, 8 spp,
# seed 6).  Against the reference's batch, the same draws: mean |diff|
# <= 0.126 and r >= 0.99979 (19-28 of 1,536 pixels differ, from the last
# place of the lens offset; ROADMAP Queue 3).  The bounds are about twice
# the measured gaps.
BATCH_MAX_DIFF, BATCH_MIN_R = 12.0, 0.95
REF_MAX_DIFF, REF_MIN_R = 0.25, 0.9995


def test_animation_matches_reference_and_unbatched(tmp_path):
    """Three frames of the final scene at 48x32, 8 spp: one batch, against
    the reference's animation (the same seeds and lanes) and against the
    port's own frame-by-frame render; out_pattern and frame_callback see
    every frame in order."""
    kw = dict(width=48, height=32, samples=8, seed=6)
    ref = jax_animation(jax_get_scene("final"),
                        jax_orbit(n_frames=3, aspect_ratio=1.5), JC(**kw))
    got = []
    cams = orbit_path(n_frames=3, aspect_ratio=1.5)
    ours = render_animation(get_scene("final"), cams, TC(**kw),
                            out_pattern=str(tmp_path / "f_%02d.png"),
                            frame_callback=lambda i, img, ms: got.append(i),
                            device="cpu")
    assert got == [0, 1, 2] and len(ours) == 3
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.shape == (32, 48, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(read_image(str(tmp_path / f"f_{i:02d}.png")), a)
        d, r = _stats(a, b)
        assert d <= REF_MAX_DIFF and r >= REF_MIN_R, (i, d, r)
    singles = render_animation(get_scene("final"), cams, TC(**kw),
                               batch_frames=1, device="cpu")
    for a, b in zip(ours, singles):
        d, r = _stats(a, b)
        assert d <= BATCH_MAX_DIFF and r >= BATCH_MIN_R, (d, r)
    assert np.abs(ours[0].astype(int) - ours[2].astype(int)).mean() > 1.0


def test_resume_skips_existing_and_rerenders_bad_files(tmp_path, monkeypatch):
    """tests/test_animation.py's resume checks on the port: batches whose
    frames read back are not rendered again, missing, empty or wrong-size
    frames re-render their batch with its own seed, so a resumed animation
    equals an uninterrupted one exactly."""
    scene = get_scene("test")
    cfg = TC(width=24, height=16, samples=16, seed=11)
    cams = orbit_path(look_to=(0, 0.5, 0), radius=12.0, height=2.0,
                      n_frames=4, aspect_ratio=1.5)
    pattern = str(tmp_path / "r_%04d.png")
    full = render_animation(scene, cams, cfg, out_pattern=pattern,
                            batch_frames=2, device="cpu")
    (tmp_path / "r_0002.png").unlink()
    (tmp_path / "r_0003.png").unlink()
    calls = []
    real = TP.render_image_persistent
    monkeypatch.setattr(TP, "render_image_persistent",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def resumed():
        return render_animation(scene, cams, cfg, out_pattern=pattern,
                                batch_frames=2, resume=True, device="cpu")
    for want_calls, spoil in ((1, None), (0, None),
                              (1, lambda: (tmp_path / "r_0001.png").write_bytes(b"")),
                              (1, lambda: write_image(str(tmp_path / "r_0000.png"),
                                                      np.zeros((8, 8, 3), np.uint8)))):
        if spoil:
            spoil()
        calls.clear()
        again = resumed()
        assert len(calls) == want_calls
        assert len(again) == 4
        for a, b in zip(full, again):
            np.testing.assert_array_equal(a, b)


def _png_all_filters(img):
    """An RGB PNG whose rows cycle through the five scanline filters."""
    h, w, _ = img.shape
    raw = img.reshape(h, w * 3).astype(np.int32)
    out = []
    for y in range(h):
        ftype, cur = y % 5, raw[y]
        prev = raw[y - 1] if y else np.zeros(w * 3, np.int32)
        left = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(16, 24), (7, 13), (1, 1)])
def test_read_image_round_trips_every_format(shape, tmp_path):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,),
                                                   np.uint8)
    for ext in ("bmp", "png", "ppm"):
        path = str(tmp_path / f"x.{ext}")
        write_image(path, img)
        back = read_image(path)
        assert back.dtype == np.uint8 and back.flags.writeable
        np.testing.assert_array_equal(back, img, err_msg=ext)
        np.testing.assert_array_equal(jax_read_image(path), back, err_msg=ext)
    path = tmp_path / "filters.png"
    path.write_bytes(_png_all_filters(img))
    np.testing.assert_array_equal(read_image(str(path)), img)
    (tmp_path / "bad.png").write_bytes(b"not an image")
    with pytest.raises(ValueError, match="unrecognized"):
        read_image(str(tmp_path / "bad.png"))
