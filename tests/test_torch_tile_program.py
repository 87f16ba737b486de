"""The tile program (``core/tile_program.py``, ``render``'s default path)
against the eager per-tile loop (``render(..., graphs=False)``), on the
CPU, where the program runs its steps on its static buffers without
capture:

* frames equal bit for bit, in f32 and in u8, on a packing mesh scene,
  a blend scene (level widths concatenate), the CSG x area-light YAML
  scene cut small in deterministic and in seeded random jitter, and fuzz
  seeds 3 and 19;
* a moved camera, or a narrower frame, reuses the program and still
  equals the eager frame; another tile size replaces the program;
* after one warm-up tile, no level uploads a numpy array or a Python
  sequence (what a CUDA graph could not capture);
* ``render.tile_rays`` against the JAX package's ``tile_rays`` op by op,
  bit for bit, on the fuzz camera, the dragons_equiv camera and 30
  seeded random cameras.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import render as JR
from raytracer_tpu_torch import scenes
from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.camera import Camera
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import tile_program as TP
from raytracer_tpu_torch.scene import build_scene
from raytracer_tpu_torch.scene.yaml_scene import parse_scene
from torch_port_helpers import jax_camera


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as the fuzz's test modules run: frames of
    thousands of small ops slow down badly when six test processes
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.cache
def case(name):
    """(scene, camera, render's keywords other than the generator)."""
    if name == "glass_mesh4":      # 25,280 free triangles: levels pack
        items, cam = scenes.glass_mesh(instances=4, hsize=64, vsize=64)
        return build_scene(items, device="cpu"), cam, {"tile_rays": 4096}
    if name == "flagship":         # blend: levels 2^L tiles wide
        items, cam = scenes.flagship(32, 24)
        return build_scene(items, device="cpu"), cam, {}
    if name.startswith("csg_area"):
        jitter = (0.5,) if name == "csg_area_det" else None
        cam, sc = parse_scene(scenes.csg_area_yaml(32, 24), jitter=jitter,
                              device="cpu")
        return sc, cam, {}
    seed, h, v = {"fuzz3": (3, 64, 64), "fuzz19": (19, 64, 48)}[name]
    return (scenes.random_scene(seed, device="cpu"),
            scenes.fuzz_camera(h, v), {})


CASES = ["glass_mesh4", "flagship", "csg_area_det", "csg_area_random",
         "fuzz3", "fuzz19"]


def frame(name, cam=None, **kw):
    sc, cam0, opts = case(name)
    g = torch.Generator().manual_seed(5) if R.draws_jitter(sc.static) \
        else None
    return R.render(sc, cam or cam0, generator=g, **opts, **kw)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_program_equals_eager(name, quantize):
    got = frame(name, quantize=quantize)
    want = frame(name, quantize=quantize, graphs=False)
    assert got.dtype == (np.uint8 if quantize else np.float32)
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0
    sc = case(name)[0]
    levels = TP.program_of(sc).levels
    assert levels[0][0] == 0
    assert len(levels) > 1 or not R.spawns(sc.static)
    if name == "glass_mesh4":
        assert any(w is not None and w < r for _, r, w in levels), levels
    if name == "flagship":
        assert [r for _, r, _ in levels[:3]] == [768, 1536, 3072], levels
    assert R.draws_jitter(sc.static) == (name == "csg_area_random")


def test_moved_camera_reuses_program():
    sc, cam, opts = case("glass_mesh4")
    frame("glass_mesh4")
    prog = TP.program_of(sc)
    moved = Camera(cam.hsize, cam.vsize, cam.field_of_view).with_transform(
        tf.view_transform((1.0, 2.5, -6.0), (0.0, 0.8, 0.0), (0.0, 1.0, 0.0)))
    got = frame("glass_mesh4", cam=moved, quantize=True)
    assert TP.program_of(sc) is prog
    np.testing.assert_array_equal(
        got, frame("glass_mesh4", cam=moved, quantize=True, graphs=False))
    assert np.abs(got.astype(int)
                  - frame("glass_mesh4", quantize=True).astype(int)).max() > 0


def test_other_width_reuses_program_other_tile_replaces_it():
    """The frame's width is a buffer of the program, not part of its
    identity: a narrower frame at the same tile replays the same program
    and equals eager. Another tile size replaces the scene's program."""
    sc, cam, opts = case("glass_mesh4")
    frame("glass_mesh4")
    prog = TP.program_of(sc)
    narrow = Camera(48, 86, cam.field_of_view).with_transform(cam.transform)
    got = frame("glass_mesh4", cam=narrow, quantize=True)
    assert TP.program_of(sc) is prog
    np.testing.assert_array_equal(
        got, frame("glass_mesh4", cam=narrow, quantize=True, graphs=False))
    other = TP.program_for(sc, prog.tile // 2, prog.limit)
    assert other is not prog and TP.program_of(sc) is other


@pytest.mark.parametrize("name", CASES)
def test_no_upload_after_warmup(name, monkeypatch):
    """The program's second tile calls torch.tensor / torch.as_tensor on no
    numpy array or Python sequence: every constant a level reads was made
    once (Scene.const, types.small_const)."""
    sc, cam, opts = case(name)
    tile = min(opts.get("tile_rays", R.pick_tile_rays(sc.static)),
               cam.hsize * cam.vsize)
    _, idx_tiles = R._order_tiles(cam.vsize, cam.hsize, tile, "cpu")
    prog = TP.program_for(sc, tile, sc.static.recursion_limit)
    prog.set_camera(*R.camera_consts(cam, "cpu"), cam.hsize)
    g = torch.Generator().manual_seed(1) if R.draws_jitter(sc.static) \
        else None
    with torch.no_grad():
        prog.run_tile(sc, idx_tiles[0], g, quantize=False)     # warm-up
    uploads = []
    for fn in ("tensor", "as_tensor"):
        real = getattr(torch, fn)

        def spy(data, *a, _real=real, _fn=fn, **kw):
            if isinstance(data, (np.ndarray, list, tuple)):
                uploads.append((_fn, type(data).__name__))
            return _real(data, *a, **kw)

        monkeypatch.setattr(torch, fn, spy)
    with torch.no_grad():
        prog.run_tile(sc, idx_tiles[-1], g, quantize=True)
    assert uploads == []
    assert len(prog.levels) >= 2          # both tiles ran


def cameras():
    yield "fuzz", scenes.fuzz_camera()
    yield "dragons_equiv", scenes.dragons_equiv()[1]
    for seed in range(1, 31):
        rng = np.random.default_rng(seed)
        frm = tuple(rng.uniform(-10.0, 10.0, 3))
        to = tuple(rng.uniform(-2.0, 2.0, 3))
        yield f"random{seed}", Camera(64, 48, float(rng.uniform(0.3, 2.5))) \
            .with_transform(tf.view_transform(frm, to, (0.0, 1.0, 0.0)))


CAMERAS = dict(cameras())


@pytest.mark.parametrize("name", list(CAMERAS))
def test_tile_rays_bit_equal_jax(name):
    """Every pixel's primary ray equals the JAX package's bit for bit: the
    einsum's pairwise sum of rounded products, the norm's fused
    multiply-add chain and a correctly rounded square root."""
    cam = CAMERAS[name]
    inv, consts = R.camera_consts(cam, "cpu")
    jinv, jconsts = JR.camera_consts(jax_camera(cam))
    idx = np.arange(cam.hsize * cam.vsize)
    o, d = R.tile_rays(inv, consts, torch.as_tensor(idx), cam.hsize)
    jo, jd = JR.tile_rays(jinv, jconsts, jnp.asarray(idx, jnp.int32),
                          cam.hsize)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert math.isclose(float(d.norm(dim=-1).mean()), 1.0, rel_tol=1e-6)
