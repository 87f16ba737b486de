"""The frame's pixel order on the device (``render.put_tile``,
``TileProgram.order``), on the CPU:

* ``render`` with ``graphs=True`` and with ``graphs=False`` gives frames
  byte-equal to the assembly on the host, ``out[order] = img`` over the
  tile-order frame of ``TileProgram.frame`` or of ``color_at`` tile by
  tile: on a mesh scene at 64x48, a blend scene at 50x37 whose last tile
  is padded, and an area-light scene drawing seeded random jitter;
* the program builds a frame size's order once (``stats["orders_built"]``)
  and keeps it for the next frames of that size, whatever the camera; a
  frame of another size builds its own and is still exact.
"""

import functools
import math

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import scenes
from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.camera import Camera
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import tile_program as TP
from raytracer_tpu_torch.scene import build_scene
from raytracer_tpu_torch.scene.yaml_scene import parse_scene


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.cache
def case(name):
    """(scene, camera, tile rays, quantize)."""
    if name == "mesh_64x48":           # three whole tiles
        items, cam = scenes.glass_mesh(instances=2, hsize=64, vsize=48)
        return build_scene(items, device="cpu"), cam, 1024, True
    if name == "blend_50x37":          # 1,850 pixels: the fourth tile pads
        items, cam = scenes.flagship(50, 37)
        return build_scene(items, device="cpu"), cam, 512, False
    cam, sc = parse_scene(scenes.csg_area_yaml(32, 24), device="cpu")
    assert R.draws_jitter(sc.static)
    return sc, cam, 320, True          # 768 pixels: the third tile pads


CASES = ["mesh_64x48", "blend_50x37", "area_seeded_32x24"]


def generator(sc):
    return torch.Generator().manual_seed(7) if R.draws_jitter(sc.static) \
        else None


def host_assembled(sc, cam, tile, quantize, graphs):
    """The frame put in image order on the host: the tile-order frame
    (the program's ``frame`` without ``pixels``, or ``color_at`` tile by
    tile), then ``out[order] = img``."""
    n = cam.vsize * cam.hsize
    order, idx_tiles = R._order_tiles(cam.vsize, cam.hsize, tile, "cpu")
    inv, consts = R.camera_consts(cam, "cpu")
    limit, g = sc.static.recursion_limit, generator(sc)
    with torch.no_grad():
        if graphs:
            prog = TP.program_for(sc, tile, limit)
            prog.set_camera(inv, consts, cam.hsize)
            frame = prog.to_host(prog.frame(sc, idx_tiles, quantize, g))
        else:
            outs = [R.color_at(sc, *R.tile_rays(inv, consts, idx, cam.hsize),
                               limit, g) for idx in idx_tiles]
            frame = torch.cat([R.quantize_u8(c) if quantize else c
                               for c in outs])
    img = frame.numpy()[:n]
    out = np.empty_like(img)
    out[order] = img
    return out.reshape(cam.vsize, cam.hsize, 3)


def rendered(sc, cam, tile, quantize, graphs=True):
    return R.render(sc, cam, tile_rays=tile, quantize=quantize,
                    generator=generator(sc), graphs=graphs)


@pytest.mark.parametrize("graphs", [True, False], ids=["graphs", "eager"])
@pytest.mark.parametrize("name", CASES)
def test_frame_equals_host_assembly(name, graphs):
    sc, cam, tile, quantize = case(name)
    n = cam.vsize * cam.hsize
    assert (n % tile == 0) == (name == "mesh_64x48")
    got = rendered(sc, cam, tile, quantize, graphs)
    want = host_assembled(sc, cam, tile, quantize, graphs)
    assert got.dtype == (np.uint8 if quantize else np.float32)
    assert got.shape == (cam.vsize, cam.hsize, 3) and got.std() > 0
    assert got.tobytes() == want.tobytes()
    if graphs:
        assert TP.program_of(sc).frame_stats["tiles"] == -(-n // tile)


@pytest.mark.parametrize("name", ["mesh_64x48", "blend_50x37"])
def test_order_built_once_per_frame_size(name):
    """Two frames of two cameras of one size build one device order; a
    frame of another size builds a second, and is exact."""
    sc, cam, tile, quantize = case(name)
    TP.drop_program(sc)
    moved = Camera(cam.hsize, cam.vsize, cam.field_of_view).with_transform(
        tf.view_transform((1.0, 2.5, -6.0), (0.0, 0.8, 0.0), (0.0, 1.0, 0.0)))
    first = rendered(sc, cam, tile, quantize)
    prog = TP.program_of(sc)
    assert prog.stats["orders_built"] == 1
    second = rendered(sc, moved, tile, quantize)
    assert TP.program_of(sc) is prog and prog.stats["orders_built"] == 1
    assert first.tobytes() != second.tobytes()
    assert second.tobytes() == host_assembled(sc, moved, tile, quantize,
                                              True).tobytes()
    other = Camera(cam.hsize - 7, cam.vsize + 5, math.pi / 3).with_transform(
        cam.transform)
    got = rendered(sc, other, tile, quantize)
    assert TP.program_of(sc) is prog and prog.stats["orders_built"] == 2
    assert got.shape == (other.vsize, other.hsize, 3)
    assert got.tobytes() == rendered(sc, other, tile, quantize,
                                     graphs=False).tobytes()
    assert prog.stats["orders_built"] == 2
