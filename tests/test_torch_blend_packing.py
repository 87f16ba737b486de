"""Packed levels of blend scenes (``core/render.packs`` with ``keeps``) on
the CPU:

* a blend scene's frame through ``render(graphs=False)`` (``color_at``
  under ``torch.no_grad()``) and through the tile program equals, bit for
  bit, the same tiles through ``color_at`` with gradients on, where the
  levels run whole: the flagship scene and two fuzz seeds of blend
  spheres, no mesh and no area light, so that the blend rule alone packs;
* the tile program takes the four widths at every level after the first,
  the train program one whole body a level (the memory guard), and a
  level packed to its whole width runs unsorted;
* the rows a frame shades (``rows_shaded``: the program's ``stats`` and
  the frame's root span) equal the sum of the level logs' widths and the
  rows the eager loop shaded.
"""

import functools

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import scenes
from raytracer_tpu_torch.camera import ray_grid
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import tile_program as TP
from raytracer_tpu_torch.core import train_program as TPG
from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.parallel import partition_scene, render_loss_and_grad
from raytracer_tpu_torch.scene import build_scene
from raytracer_tpu_torch.utils import profiling as P


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.cache
def case(name):
    """(scene, camera, tile): blend scenes whose packing comes from the
    blend rule alone (no mesh over 20,000 triangles, no area light)."""
    if name == "flagship":
        items, cam = scenes.flagship(64, 48)
        sc = build_scene(items, device="cpu")
    else:
        sc, cam = (scenes.random_scene(int(name[4:]), device="cpu"),
                   scenes.fuzz_camera(64, 48))
    st = sc.static
    assert st.has_blend and not st.area_steps
    assert st.counts[5] - st.n_csg_tris <= 20000
    return sc, cam, 3072


CASES = ["flagship", "fuzz5", "fuzz13"]


def level_rays():
    """The flagship scene and 4,096 of its camera rays: a level that packs
    (R >= 4096)."""
    items, cam = scenes.flagship(64, 64)
    return (case("flagship")[0], *ray_grid(cam, device="cpu"))


def whole_frame(sc, cam, tile):
    """``render``'s frame, float32, each tile through ``color_at`` with
    gradients on: every level whole (``packs`` with ``keeps``)."""
    order, idx_tiles = R._order_tiles(cam.vsize, cam.hsize, tile, "cpu")
    inv, consts = R.camera_consts(cam, "cpu")
    with torch.enable_grad():
        tiles = [R.color_at(sc, *R.tile_rays(inv, consts, idx, cam.hsize),
                            sc.static.recursion_limit).detach()
                 for idx in idx_tiles]
    img = torch.cat(tiles).numpy()[:cam.vsize * cam.hsize]
    out = np.empty_like(img)
    out[order] = img
    return out.reshape(cam.vsize, cam.hsize, 3)


@pytest.mark.parametrize("name", CASES)
def test_packed_blend_frames_equal_whole_levels(name):
    sc, cam, tile = case(name)
    want = whole_frame(sc, cam, tile)
    eager = R.render(sc, cam, tile_rays=tile, graphs=False)
    graphed = R.render(sc, cam, tile_rays=tile)
    assert want.std() > 0
    assert eager.tobytes() == want.tobytes()
    assert graphed.tobytes() == want.tobytes()
    levels = TP.program_of(sc).levels
    packed = [(r, w) for lv, r, w in levels if lv and w < r]
    assert packed, levels
    assert all(w is not None for lv, _, w in levels if lv)


def test_tile_program_packs_blend_levels_train_program_keeps_them_whole():
    sc, cam, tile = case("flagship")
    st = sc.static
    prog = TP.TileProgram(st, "cpu", tile, st.recursion_limit)
    assert prog.branches[0] == (None,)
    for rows, branches in zip(prog.rows[1:], prog.branches[1:]):
        assert branches == (rows // 16, rows // 4, rows // 2, rows)
        assert R.packs(st, rows, keeps=False)
        assert not R.packs(st, rows, keeps=True)
    o, d = ray_grid(cam, device="cpu")
    params, recombine = partition_scene(sc)
    m = o.shape[0] // 2
    render_loss_and_grad(params, recombine, o, d, torch.zeros_like(o),
                         n_micro=2)
    train = TPG.programs()[0]
    assert train.rows == m
    assert set(train.branches.values()) <= {(None, R.DEAD)}
    assert {w for _, _, w in train.levels} == {None}
    # a mesh or area-light level packs whatever it keeps
    mesh = T.SceneStatic(counts=(0, 0, 0, 0, 0, 25280))
    for keeps in (False, True):
        assert R.level_branches(mesh, 4096, keeps=keeps) == (
            256, 1024, 2048, 4096)


def test_a_blend_level_at_its_whole_width_runs_unsorted(monkeypatch):
    sc, o, d = level_rays()
    w = torch.ones_like(o)
    w[::3] = 0.0
    o, d = R.park_rays(o, d, (w > 0).any(-1))

    def no_sort(*a, **kw):
        raise AssertionError("a whole-width blend level sorted its rays")

    with torch.no_grad():
        want = R.shade_level(sc, o, d, w)
        monkeypatch.setattr(R, "_packed_shade_level", no_sort)
        got = R.shade_step(sc, o, d, w, None, width=4096)
    assert len(got) == 3
    flat = lambda out: [out[0], *out[1], *out[2]]  # noqa: E731
    for x, y in zip(flat(got), flat(want)):
        assert x.numpy().tobytes() == y.numpy().tobytes()


def eager_rows(sc, cam, tile, monkeypatch):
    """The rows the eager loop (``graphs=False``) shades, tile by tile:
    level 0 whole, every later level it ran at its width, or whole."""
    tiles, real_width, real_color_at = [], R.level_width, R.color_at

    def color_at(*a, **kw):
        tiles.append([a[1].shape[0]])
        return real_color_at(*a, **kw)

    def level_width(st, rows, n_live, **kw):
        width = real_width(st, rows, n_live, **kw)
        tiles[-1].append(width or rows)
        return width

    monkeypatch.setattr(R, "color_at", color_at)
    monkeypatch.setattr(R, "level_width", level_width)
    R.render(sc, cam, tile_rays=tile, graphs=False)
    monkeypatch.undo()
    return tiles


@pytest.mark.parametrize("name", ["flagship", "fuzz5"])
def test_rows_shaded_equal_the_logs_and_the_eager_loop(name, monkeypatch):
    sc, cam, tile = case(name)
    want = eager_rows(sc, cam, tile, monkeypatch)
    TP.drop_program(sc)
    P.clear()
    P.enable()
    try:
        R.render(sc, cam, tile_rays=tile)
        R.render(sc, cam, tile_rays=tile)
        roots = [s for s in P.spans() if s.parent is None]
    finally:
        P.disable()
        P.clear()
    prog = TP.program_of(sc)
    logged = sum(w or r for _, r, w in prog.levels)
    total = sum(map(sum, want))
    assert logged == total
    assert prog.stats["rows_shaded"] == 2 * total
    assert [s.name for s in roots] == ["frame", "frame"]
    assert [s.attrs["rows_shaded"] for s in roots] == [total, total]
    # the packed levels shade fewer rows than the whole levels would
    whole = sum(r for _, r, _ in prog.levels)
    assert total < whole
