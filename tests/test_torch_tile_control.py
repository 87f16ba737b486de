"""The tile program's level control (``core/tile_program.py``) on the CPU,
where the control kernel's plain version computes the same level flags as
the card's conditional nodes and the host reads them:

* ``graph_cuda.level_control_plain`` against ``render.level_width`` for
  every live count from 0 to ``rows`` at 4096, 8192 and 16384 rows, on
  packing statics (a big mesh, an area light) and non-packing ones, read
  as the CPU path reads them (``graph_cuda.level_control_cpu``);
* the ``levels`` the program rebuilds from its level logs equal, tile by
  tile, the widths the eager loop (``graphs=False``) took, on a packing
  mesh scene, a blend scene and a random-jitter area-light scene;
* a scene whose rays all die at level 1: every later level stays skipped
  (logged -1), tiles that miss everything skip level 1 too, and the
  frame equals the eager one bit for bit.
"""

import functools
import math

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.camera import Camera
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import tile_program as TP
from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.ops import graph_cuda as GC
from raytracer_tpu_torch.scene import build_scene, specs as S
from test_torch_tile_program import _two_threads, case  # noqa: F401

STATICS = {
    "mesh": T.SceneStatic(counts=(0, 0, 0, 0, 0, 25280)),
    "area": T.SceneStatic(counts=(1, 0, 0, 0, 0, 0), area_steps=((2, 2),)),
    "spheres": T.SceneStatic(counts=(3, 1, 0, 0, 0, 0)),
    "few_tris": T.SceneStatic(counts=(0, 0, 0, 0, 0, 20000)),
}


def check_plain_decision(st, rows, dead):
    """``graph_cuda.level_control_plain`` of a level of ``rows`` rays
    (branches ``render.level_branches(st, rows, dead=dead)``) for every
    live count from 0 to ``rows`` against ``render.level_width``: the set
    flag the width's branch, none set at 0 without the dead level and the
    dead one with it (so exactly one set with the dead level), the log
    entry the branch's code (-1 for none or the dead level); and a scalar
    count through ``level_control_cpu``, as the CPU programs decide: the
    same flags and entry written into buffers, the set flag's index
    returned."""
    branches = R.level_branches(st, rows, dead=dead)
    codes = GC.branch_codes(branches)
    live = torch.arange(rows + 1)
    flags, log = GC.level_control_plain(live, rows, codes)
    assert flags.dtype == log.dtype == torch.int32
    assert tuple(flags.shape) == (rows + 1, len(branches))
    assert flags.sum(-1).tolist() == [int(dead)] + [1] * rows
    want = [R.DEAD if dead else None] + [R.level_width(st, rows, n)
                                         for n in range(1, rows + 1)]
    taken = flags.argmax(-1).tolist()
    assert [branches[k] for k in taken[1 - dead:]] == want[1 - dead:]
    assert log.tolist() == [-1] + [w or 0 for w in want[1:]]
    for n in (0, 1, rows // 16, rows // 16 + 1, rows):   # a scalar count
        f = torch.full((len(branches),), 7, dtype=torch.int32)
        entry = torch.full((), 7, dtype=torch.int32)
        k = GC.level_control_cpu(torch.tensor(n), rows, codes, f, entry)
        assert torch.equal(f, flags[n]) and int(entry) == int(log[n])
        assert k == (taken[n] if n or dead else None)


@pytest.mark.parametrize("rows", [4096, 8192, 16384])
@pytest.mark.parametrize("kind", list(STATICS))
def test_predicates_equal_level_width(kind, rows):
    st = STATICS[kind]
    assert R.packs(st, rows) == (kind in ("mesh", "area"))
    check_plain_decision(st, rows, dead=False)


def _eager_widths(name, monkeypatch):
    """The eager frame of ``name`` and, per tile, the (rows, width) of
    each level after the first that its loop ran."""
    sc, cam, opts = case(name)
    tiles, real = [], R.level_width
    real_color_at = R.color_at

    def color_at(*a, **kw):
        tiles.append([])
        return real_color_at(*a, **kw)

    def level_width(st, rows, n_live, **kw):
        width = real(st, rows, n_live, **kw)
        tiles[-1].append((rows, width))
        return width

    monkeypatch.setattr(R, "color_at", color_at)
    monkeypatch.setattr(R, "level_width", level_width)
    g = torch.Generator().manual_seed(5) if R.draws_jitter(sc.static) \
        else None
    img = R.render(sc, cam, generator=g, graphs=False, **opts)
    monkeypatch.undo()
    return img, tiles


@pytest.mark.parametrize("name", ["glass_mesh4", "flagship",
                                  "csg_area_random"])
def test_levels_from_log_equal_eager_widths(name, monkeypatch):
    want_img, want = _eager_widths(name, monkeypatch)
    sc, cam, opts = case(name)
    g = torch.Generator().manual_seed(5) if R.draws_jitter(sc.static) \
        else None
    img = R.render(sc, cam, generator=g, **opts)
    np.testing.assert_array_equal(img, want_img)
    prog = TP.program_of(sc)
    got, rows0 = [], prog.rows[0]
    for level, rows, width in prog.levels:
        if level == 0:
            assert rows == rows0
            got.append([])
        else:
            assert level == len(got[-1]) + 1
            got[-1].append((rows, width))
    assert got == want
    assert len(got) == prog.frame_stats["tiles"] == len(want)
    assert prog.frame_stats["syncs"] == 1
    if name == "glass_mesh4":
        assert any(w is not None and w < r for t in got for r, w in t)


@functools.cache
def one_bounce():
    """A mirror sphere alone: its reflections leave the scene, so every
    ray dies at level 1; the frame's corner tiles miss it at level 0."""
    items = [S.PointLight(position=(-10, 10, -10)),
             S.Sphere(material=S.Material(color=(1.0, 0.2, 0.2),
                                          reflective=0.6))]
    cam = Camera(64, 32, math.pi / 3).with_transform(
        tf.view_transform((0.0, 0.0, -5.0), (0.0, 0.0, 0.0),
                          (0.0, 1.0, 0.0)))
    return build_scene(items, recursion_limit=4, device="cpu"), cam


@pytest.mark.parametrize("quantize", [False, True])
def test_rays_dead_after_level_1_skip_later_levels(quantize):
    sc, cam = one_bounce()
    got = R.render(sc, cam, tile_rays=256, quantize=quantize)
    want = R.render(sc, cam, tile_rays=256, quantize=quantize, graphs=False)
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0
    prog = TP.program_of(sc)
    assert len(prog.rows) == 5 and prog.frame_stats["tiles"] == 8
    per_tile = {}
    for level, _, width in prog.levels:
        if level == 0:
            per_tile[len(per_tile)] = []
        per_tile[len(per_tile) - 1].append(level)
        assert width is None
    assert sorted(set(map(tuple, per_tile.values()))) == [(0,), (0, 1)]
    assert all(int(x) == -1 for x in prog.log[2:])
    assert int(prog.live) == 0
