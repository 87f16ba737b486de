"""Checkpoint/resume and profiling utilities of raytracer_tpu_torch
(``utils/``): tests/test_utils.py's three tests on the port, the resumable
frame against the JAX package's render, a seeded area-light frame resumed
bit for bit, and the profiler hook."""

import math

import jax
import numpy as np
import pytest

from raytracer_tpu.core.render import render as jax_render
from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.camera import Camera
from raytracer_tpu_torch.core.render import render
from raytracer_tpu_torch.scene import build_scene, specs as S
from raytracer_tpu_torch.utils import (
    RenderStats, render_resumable, trace_profile)
from raytracer_tpu_torch.utils import checkpoint as CK
from torch_port_helpers import jax_camera, same_tables


def small_items():
    return [
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Plane(material=S.Material(specular=0.0)),
        S.Sphere(transform=tf.translation(-0.5, 1.0, 0.5),
                 material=S.Material(color=(0.1, 0.4, 0.9), diffuse=0.7)),
    ]


def small_camera():
    return Camera(32, 16, math.pi / 3).with_transform(
        tf.view_transform((0, 1.5, -5), (0, 1, 0), (0, 1, 0)))


def small():
    return build_scene(small_items(), device="cpu"), small_camera()


def test_resumable_matches_render(tmp_path):
    scene, cam = small()
    direct = render(scene, cam, tile_rays=128)
    stats = RenderStats()
    img = render_resumable(scene, cam, tmp_path / "ck", tile_rays=128,
                           stats=stats)
    assert np.allclose(img, direct, atol=1e-6)
    assert stats.tiles == 4 and stats.primary_rays == 32 * 16
    assert stats.rays_per_sec > 0
    assert "rays/s" in stats.summary()

    # resume: nothing left to do, identical result
    stats2 = RenderStats()
    img2 = render_resumable(scene, cam, tmp_path / "ck", tile_rays=128,
                            stats=stats2)
    assert stats2.tiles == 0
    assert np.allclose(img2, direct, atol=1e-6)


def test_resume_after_partial(tmp_path):
    scene, cam = small()
    direct = render(scene, cam, tile_rays=128)
    render_resumable(scene, cam, tmp_path / "ck", tile_rays=128)
    # clear one tile's done flag -> only that tile renders again
    done = np.lib.format.open_memmap(tmp_path / "ck" / "done.npy", mode="r+")
    done[2] = False
    done.flush()
    stats = RenderStats()
    img = render_resumable(scene, cam, tmp_path / "ck", tile_rays=128,
                           stats=stats)
    assert stats.tiles == 1
    assert np.allclose(img, direct, atol=1e-6)


def test_failure_detection_retries(tmp_path, monkeypatch):
    """A tile whose call fails transiently (an exception or non-finite
    output) is detected, retried, and the render completes; a persistent
    failure raises with every other tile checkpointed."""
    scene, cam = small()
    direct = render(scene, cam, tile_rays=128)

    real = CK._tile_color
    fails = {"left": 2}

    def flaky(*args):
        out = real(*args)
        if fails["left"] > 0:
            fails["left"] -= 1
            if fails["left"] % 2:
                raise RuntimeError("injected transport fault")
            return out * np.nan  # injected device corruption
        return out

    monkeypatch.setattr(CK, "_tile_color", flaky)
    seen = []
    img = render_resumable(
        scene, cam, tmp_path / "ck", tile_rays=128, max_retries=2,
        on_retry=lambda ti, attempt, reason: seen.append((ti, reason)),
    )
    assert np.allclose(img, direct, atol=1e-6)
    assert len(seen) == 2
    assert any("injected transport fault" in r for _, r in seen)
    assert any("non-finite" in r for _, r in seen)

    # persistent failure: raises, but finished tiles stay checkpointed
    calls = {"n": 0}

    def fails_after_first(*args):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("persistent device fault")
        return real(*args)

    monkeypatch.setattr(CK, "_tile_color", fails_after_first)
    with pytest.raises(RuntimeError, match="tile 1 failed"):
        render_resumable(scene, cam, tmp_path / "ck2", tile_rays=128,
                         max_retries=1)
    done = np.lib.format.open_memmap(tmp_path / "ck2" / "done.npy", mode="r")
    assert done[0] and not done[1:].any()


def test_resumable_matches_jax_render(tmp_path):
    """The port's resumable frame against the JAX package's render of the
    same tables, run op by op (``jax.disable_jit``: the port follows the
    op-by-op rounding; the jit-compiled frame differs by a few ulps on
    specular pixels). Float to rtol 1e-5, atol 1e-6: the JAX package's
    own bound of 1e-6 holds on all but 4 of the 1536 values, where the two
    packages' f32 shading rounds apart (2.7e-6 at most, on values near
    0.3)."""
    js, ps = same_tables(small_items())
    cam = small_camera()
    with jax.disable_jit():
        want = jax_render(js, jax_camera(cam), tile_rays=128)
    got = render_resumable(ps, cam, tmp_path / "ck", tile_rays=128)
    assert got.shape == want.shape == (16, 32, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.std() > 0.05


def test_seeded_area_light_resume_is_bit_equal(tmp_path):
    """Seeded (not deterministic) area-light jitter: each tile draws from
    its own generator seeded from (seed, tile), so a frame resumed after
    clearing one tile's done flag equals the uninterrupted frame bit for
    bit, and another seed gives another frame. The checkpoint's digest
    covers the seed: a run with another seed starts afresh."""
    items = [
        S.AreaLight(corner=(-3.0, 6.0, -4.0), uvec=(2.0, 0.0, 0.0), usteps=2,
                    vvec=(0.0, 0.0, 2.0), vsteps=2),
        S.Plane(material=S.Material(specular=0.0)),
        S.Sphere(transform=tf.translation(-0.3, 1.0, 0.5),
                 material=S.Material(color=(0.9, 0.4, 0.1), diffuse=0.7,
                                     reflective=0.3)),
    ]
    scene = build_scene(items, recursion_limit=2, device="cpu")
    cam = small_camera()
    whole = render_resumable(scene, cam, tmp_path / "a", tile_rays=128,
                             seed=3)
    render_resumable(scene, cam, tmp_path / "b", tile_rays=128, seed=3)
    done = np.lib.format.open_memmap(tmp_path / "b" / "done.npy", mode="r+")
    done[1] = False
    done.flush()
    stats = RenderStats()
    resumed = render_resumable(scene, cam, tmp_path / "b", tile_rays=128,
                               seed=3, stats=stats)
    assert stats.tiles == 1
    assert np.array_equal(resumed, whole)
    stats = RenderStats()
    other = render_resumable(scene, cam, tmp_path / "b", tile_rays=128,
                             seed=4, stats=stats)
    assert stats.tiles == 4
    assert not np.array_equal(other, whole)
    assert np.abs(other - whole).mean() < 0.05     # the same light, resampled


def test_trace_profile_writes_a_trace(tmp_path):
    scene, cam = small()
    with trace_profile(str(tmp_path / "prof")):
        render(scene, cam)
    trace = tmp_path / "prof" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    assert b"traceEvents" in trace.read_bytes()[:4096]
