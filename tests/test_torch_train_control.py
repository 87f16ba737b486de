"""The train program's level control (``core/train_program.py``) on the
CPU, where the control kernel's plain version computes the same level
flags as the card's conditional nodes, the dead level's among them, and
the host reads them:

* ``graph_cuda.level_control_plain`` with the dead level: exactly one
  flag set for every live count from 0 to ``rows``, on packing and
  non-packing statics, the set one the width of ``render.level_width``
  (the dead level's at 0);
* the ``levels`` the program rebuilds from its level logs equal,
  microbatch by microbatch, the widths the eager step (``graphs=False``)
  took, on a glass scene (its levels pack), the flagship (blend, no
  packing) and a mesh pose scene whose rays require grad;
* a step whose two microbatches take different paths (the first dead
  from level 1, the second not): loss and every gradient equal to the
  eager step's bit for bit (``.tobytes()``, so a signed zero shows), the
  tables left None the same as eager's, for remat off and on;
* at three microbatches, the loss of either path is the microbatch
  losses' sum times fl(1/3) bit for bit, as the JAX package rounds it;
* the same scene's ``render_loss_and_grad`` against the JAX package's
  (its ``lax.scan`` over the microbatches, run op by op under
  ``jax.disable_jit``), rtol 1e-4.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.parallel.train import (
    partition_scene as jax_partition,
    render_loss_and_grad as jax_loss_and_grad)
from raytracer_tpu_torch import scenes
from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.camera import (
    Camera, ray_grid, ray_grid_tensor, view_transform_tensor)
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import train_program as TPG
from raytracer_tpu_torch.parallel import (
    partition_scene, render_loss, render_loss_and_grad)
from raytracer_tpu_torch.parallel import train as P
from raytracer_tpu_torch.scene import build_scene, specs as S
from test_torch_tile_control import STATICS, check_plain_decision
from torch_port_helpers import assert_grads_match, same_tables


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: with more, the eager backward is not
    reproducible bit for bit even against itself (``index_put_``'s
    accumulate adds across threads in their order of arrival)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rows", [4096, 16384])
@pytest.mark.parametrize("kind", list(STATICS))
def test_predicates_with_dead_flag(kind, rows):
    st = STATICS[kind]
    branches = R.level_branches(st, rows, dead=True)
    assert branches[-1] == R.DEAD
    assert branches[:-1] == R.level_branches(st, rows)
    check_plain_decision(st, rows, dead=True)


def paths_items():
    """A mirror sphere low in the frame over a slightly reflective floor:
    the top half of the rays sees only sky, so its level 1 is dead; the
    bottom half's reflections run levels 1 and 2, and its level 3 is
    dead."""
    return [
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Plane(transform=tf.translation(0.0, -1.0, 0.0),
                material=S.Material(color=(0.9, 0.8, 0.7), specular=0.0,
                                    reflective=0.2)),
        S.Sphere(material=S.Material(color=(0.2, 0.3, 1.0), diffuse=0.6,
                                     reflective=0.6)),
    ]


def paths_rays():
    cam = Camera(32, 16, math.pi / 3).with_transform(
        tf.view_transform((0.0, 0.0, -5.0), (0.0, 1.3, 0.0),
                          (0.0, 1.0, 0.0)))
    o, d = ray_grid(cam, device="cpu")
    target = torch.as_tensor(np.random.default_rng(2).uniform(
        0, 1, (o.shape[0], 3)), dtype=torch.float32)
    return o, d, target


@functools.cache
def paths_scene():
    return build_scene(paths_items(), recursion_limit=3, device="cpu")


def eager_nones(params, recombine, o, d, target, n_micro, remat):
    """The tables whose leaf ``.grad`` stays None over an eager step of
    ``n_micro`` microbatches."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    m = o.shape[0] // n_micro
    for i in range(n_micro):
        sl = slice(i * m, (i + 1) * m)
        render_loss(leaves, recombine, o[sl], d[sl], target[sl],
                    remat=remat).backward()
    return {k for k, v in leaves.items() if v.grad is None}


def bits(t):
    return t.detach().numpy().tobytes()


@pytest.mark.parametrize("remat", [False, True])
def test_microbatches_on_different_paths_equal_eager_bit_for_bit(remat):
    o, d, target = paths_rays()
    params, recombine = partition_scene(paths_scene())
    got = render_loss_and_grad(params, recombine, o, d, target, n_micro=2,
                               remat=remat)
    prog = TPG.programs()[0]
    want = render_loss_and_grad(params, recombine, o, d, target, n_micro=2,
                                remat=remat, graphs=False)
    assert bits(got[0]) == bits(want[0])
    assert set(got[1]) == set(want[1])
    for k, g in want[1].items():
        assert bits(got[1][k]) == bits(g), k
    assert float(got[1]["mat"].abs().sum()) > 0
    # the paths: the first microbatch dead from level 1, the second not
    micro = [[]]
    for level, _, _ in prog.levels:
        if level == 0 and micro[-1]:
            micro.append([])
        micro[-1].append(level)
    assert micro == [[0], [0, 1, 2]]
    # the tables left None (zeros through render_loss_and_grad) are
    # eager's: the step reads them from the logs, its one sync
    syncs = prog.stats["syncs"]
    _, graphed = P._graphed_loss_and_grad(params, recombine, o, d, target,
                                          None, 2, remat)
    assert TPG.programs()[0] is prog and prog.stats["syncs"] == syncs + 1
    nones = {k for k, g in graphed.items() if g is None}
    assert nones == eager_nones(params, recombine, o, d, target, 2, remat)
    assert nones and "mat" not in nones


def test_microbatches_on_different_paths_match_jax():
    """The graphed render_loss_and_grad (2 microbatches, remat off) of the
    different-paths scene against the JAX package's, on the same tables
    and rays: its ``lax.scan`` over the microbatches and its ``lax.cond``
    level skip, op by op under ``jax.disable_jit``."""
    o, d, target = paths_rays()
    js, ps = same_tables(paths_items(), recursion_limit=3)
    jp, jr = jax_partition(js)
    with jax.disable_jit():
        j_loss, j_grads = jax_loss_and_grad(
            jp, jr, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(target.numpy()), None, n_micro=2, remat=False)
    params, recombine = partition_scene(ps)
    loss, grads = render_loss_and_grad(params, recombine, o, d, target,
                                       n_micro=2, remat=False)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert set(grads) == set(jp)
    assert_grads_match(grads, j_grads)
    assert float(np.abs(np.asarray(j_grads["mat"])).sum()) > 0


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphed"])
def test_microbatched_loss_is_sum_times_reciprocal(graphs):
    """At n_micro=3 the returned loss is the microbatch losses' sum times
    fl(1/3), bit for bit, as the JAX package's ``loss_sum * (1.0 /
    n_micro)`` (ROADMAP F7); the target is drawn so that the sum divided
    by 3 rounds to another float."""
    cam = Camera(48, 16, math.pi / 3).with_transform(
        tf.view_transform((0.0, 0.0, -5.0), (0.0, 1.3, 0.0),
                          (0.0, 1.0, 0.0)))
    o, d = ray_grid(cam, device="cpu")
    target = torch.as_tensor(np.random.default_rng(3).uniform(
        0, 1, (o.shape[0], 3)), dtype=torch.float32)
    params, recombine = partition_scene(paths_scene())
    loss, _ = render_loss_and_grad(params, recombine, o, d, target,
                                   n_micro=3, remat=False, graphs=graphs)
    m = o.shape[0] // 3
    total = torch.zeros(())
    with torch.no_grad():
        for i in range(3):
            sl = slice(i * m, (i + 1) * m)
            total = total + render_loss(params, recombine, o[sl], d[sl],
                                        target[sl], remat=False)
    want = total * (1.0 / 3)
    assert bits(want) != bits(total / 3)
    assert bits(loss) == bits(want)


AREA = S.AreaLight(corner=(-3.0, 6.0, -4.0), uvec=(2.0, 0.0, 0.0), usteps=2,
                   vvec=(0.0, 0.0, 2.0), vsteps=2)


@functools.cache
def widths_case(name):
    """(scene, origins, directions, target, n_micro); the rays of the pose
    case are made from an eye that requires grad, anew on each call."""
    rng = np.random.default_rng(0)
    if name == "glass":        # 4,096 rays a microbatch: its levels pack
        items, _ = scenes.mesh_grad(True)
        cam = Camera(64, 64, scenes.GRAD_FOV).with_transform(
            tf.view_transform(scenes.GRAD_EYE, scenes.GRAD_TO,
                              scenes.GRAD_UP))
        sc = build_scene([AREA] + items[1:], recursion_limit=2,
                         jitter=(0.5,), device="cpu")
        o, d = ray_grid(cam, device="cpu")
        n_micro = 1
    elif name == "flagship":   # blend levels double; microbatches differ
        items, cam = scenes.flagship(16, 8)
        sc = build_scene(items, device="cpu")
        o, d = ray_grid(cam, device="cpu")
        n_micro = 4
    else:                      # the pose: rays that require grad
        items, cam = scenes.mesh_grad(False, 32, 24)
        sc = build_scene(items, recursion_limit=2, device="cpu")
        o = d = None
        n_micro = 2
    n = cam.hsize * cam.vsize
    target = torch.as_tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32)
    return sc, cam, o, d, target, n_micro


def pose_rays(cam):
    eye = torch.tensor(scenes.GRAD_EYE, requires_grad=True)
    inv = torch.linalg.inv(view_transform_tensor(eye, scenes.GRAD_TO,
                                                 scenes.GRAD_UP))
    return ray_grid_tensor(inv, cam.hsize, cam.vsize, cam.field_of_view)


@pytest.mark.parametrize("name", ["glass", "flagship", "pose"])
def test_levels_from_logs_equal_eager_widths(name, monkeypatch):
    sc, cam, o, d, target, n_micro = widths_case(name)
    params, recombine = partition_scene(sc)
    runs = {}
    for graphs in (False, True):
        if o is None:
            o, d = pose_rays(cam)
        micro, real = [], R.level_width
        real_color_at = P.color_at

        def color_at(*a, **kw):
            micro.append([])
            return real_color_at(*a, **kw)

        def level_width(st, rows, n_live, **kw):
            width = real(st, rows, n_live, **kw)
            micro[-1].append((rows, width))
            return width

        monkeypatch.setattr(P, "color_at", color_at)
        monkeypatch.setattr(R, "level_width", level_width)
        runs[graphs] = (*render_loss_and_grad(
            params, recombine, o, d, target, n_micro=n_micro, remat=False,
            graphs=graphs), micro)
        monkeypatch.undo()
        if name == "pose":
            o = None
    (gl, gg, _), (el, eg, want) = runs[True], runs[False]
    assert torch.equal(gl, el)
    assert all(torch.equal(gg[k], eg[k]) for k in eg)
    prog = TPG.programs()[0]
    got = []
    for level, rows, width in prog.levels:
        if level == 0:
            assert rows == target.shape[0] // n_micro
            got.append([])
        else:
            got[-1].append((rows, width))
    assert len(want) == n_micro and got == want
    if name == "glass":
        assert any(w is not None and w < r for t in got for r, w in t)
    if name == "flagship":
        assert len({len(t) for t in got}) > 1       # the paths differ
    if name == "pose":
        assert prog.ray_grad == (True, True)
