"""The train program (``core/train_program.py``: the default path of
``render_loss_and_grad``, ``train_step``, ``make_optim_step`` and
``make_sharded_train_step``) against the eager step (``graphs=False``), on
the CPU, where the program runs its level steps on its static buffers
without capture:

* loss, every gradient table and the generator's state equal bit for bit
  on a transparent mesh under an area light (K1 in its three modes
  through the plain version, packed levels), a blend scene (its levels
  double), an area light with seeded random jitter, and the eye's pose
  through rays that require grad; microbatches 1 and 4 (2 for the pose),
  remat on and off;
* ``train_step``'s updated tables and ``make_optim_step``'s Adam over three
  steps equal bit for bit;
* a second step finds the program again (its scene is new), runs the same
  keys, makes no buffer and uploads nothing;
* a forward replayed before its backward raises, and the pending backward
  still gives the eager gradients;
* the graphed ``train_step`` against the JAX package's op-by-op
  ``render_loss`` gradients and SGD update, at ``test_torch_train.py``'s
  bounds (rtol 1e-4, atol 1e-6).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.parallel.train import (
    partition_scene as jax_partition, render_loss as jax_render_loss)
from raytracer_tpu_torch import scenes
from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.camera import (
    Camera, ray_grid, ray_grid_tensor, view_transform_tensor)
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import train_program as TPG
from raytracer_tpu_torch.parallel import (
    make_optim_step, partition_scene, render_loss_and_grad, train_step)
from raytracer_tpu_torch.scene import build_scene, specs as S
from torch_port_helpers import same_tables

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: with more, the eager backward is not
    reproducible bit for bit even against itself (``index_put_``'s
    accumulate adds across threads in their order of arrival)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


AREA = S.AreaLight(corner=(-3.0, 6.0, -4.0), uvec=(2.0, 0.0, 0.0), usteps=2,
                   vvec=(0.0, 0.0, 2.0), vsteps=2)


def block_rays(cam):
    """The camera's rays in render's 16x16-block order."""
    o, d = ray_grid(cam, device="cpu")
    order = torch.tensor(R._block_order(cam.vsize, cam.hsize, 16))
    return o[order].contiguous(), d[order].contiguous()


def small_items():
    """tests/test_grad_parallel.py's small_setup scene."""
    return [
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Plane(material=S.Material(specular=0.0, reflective=0.2)),
        S.Sphere(transform=tf.translation(-0.5, 1.0, 0.5),
                 material=S.Material(color=(0.1, 0.4, 0.9), diffuse=0.7)),
    ]


def small_rays(hsize=16, vsize=8):
    cam = Camera(hsize, vsize, math.pi / 3).with_transform(
        tf.view_transform((0, 1.5, -5), (0, 1, 0), (0, 1, 0)))
    return ray_grid(cam, device="cpu")


@functools.cache
def case(name):
    """(scene, origins, directions, target, jitter seed or None)."""
    rng = np.random.default_rng(0)
    if name == "mesh_glass":
        # the transparent mesh (behind queries) under an area light (any-hit
        # shadow queries): 4,096 rays, so the levels after the first pack
        items, _ = scenes.mesh_grad(True)
        cam = Camera(64, 64, scenes.GRAD_FOV).with_transform(
            tf.view_transform(scenes.GRAD_EYE, scenes.GRAD_TO,
                              scenes.GRAD_UP))
        sc = build_scene([AREA] + items[1:], recursion_limit=2,
                         jitter=(0.5,), device="cpu")
        o, d = block_rays(cam)
        seed = None
    elif name == "flagship":
        items, cam = scenes.flagship(16, 8)
        sc = build_scene(items, device="cpu")
        o, d = ray_grid(cam, device="cpu")
        seed = None
    elif name == "area_random":
        items = [AREA] + small_items()[1:]
        cam = Camera(64, 64, math.pi / 3).with_transform(
            tf.view_transform((0, 1.5, -5), (0, 1, 0), (0, 1, 0)))
        sc = build_scene(items, recursion_limit=2, device="cpu")
        o, d = block_rays(cam)
        seed = 7
    else:
        raise KeyError(name)
    target = torch.as_tensor(rng.uniform(0, 1, (o.shape[0], 3)),
                             dtype=torch.float32)
    return sc, o, d, target, seed


def generator(seed):
    return None if seed is None else torch.Generator().manual_seed(seed)


def loss_and_grads(name, graphs, n_micro, remat):
    sc, o, d, target, seed = case(name)
    params, recombine = partition_scene(sc)
    g = generator(seed)
    loss, grads = render_loss_and_grad(params, recombine, o, d, target, g,
                                       n_micro=n_micro, remat=remat,
                                       graphs=graphs)
    return loss, grads, None if g is None else g.get_state()


def assert_equal(got, want):
    (gl, gg, gs), (wl, wg, ws) = got, want
    assert torch.equal(gl, wl), (float(gl), float(wl))
    assert set(gg) == set(wg)
    for k in wg:
        assert torch.equal(gg[k], wg[k]), k
    assert (gs is None) == (ws is None) and (gs is None or torch.equal(gs, ws))


@pytest.mark.parametrize("name,n_micro,remat", [
    ("mesh_glass", 1, False), ("mesh_glass", 4, True),
    ("flagship", 1, True), ("flagship", 4, False),
    ("area_random", 1, False), ("area_random", 4, True),
])
def test_graphed_grads_equal_eager(name, n_micro, remat, monkeypatch):
    modes = []
    if name == "mesh_glass":
        from raytracer_tpu_torch.ops import mesh_cuda as MC
        real = MC.mesh_nearest_plain

        def spy(*a, **kw):
            modes.append("behind" if kw.get("reverse") else
                         "any_hit" if kw.get("any_hit") else "nearest")
            return real(*a, **kw)

        monkeypatch.setattr(MC, "mesh_nearest_plain", spy)
    got = loss_and_grads(name, True, n_micro, remat)
    want = loss_and_grads(name, False, n_micro, remat)
    assert_equal(got, want)
    assert float(sum(g.abs().sum() for g in got[1].values())) > 0
    sc = case(name)[0]
    prog = TPG.programs()[0]
    assert any(t is sc.mat_id for t in prog.rest)    # the frozen tables
    # the levels of the step's last microbatch (``levels`` holds every
    # microbatch's, each starting at level 0)
    starts = [i for i, (level, _, _) in enumerate(prog.levels) if level == 0]
    assert len(starts) == n_micro
    levels = prog.levels[starts[-1]:]
    if name == "mesh_glass":
        assert set(modes) == {"nearest", "any_hit", "behind"}, set(modes)
        if n_micro == 1:          # 4,096 rays: level 1 runs packed
            assert levels[1][2] is not None and levels[1][2] < 4096, levels
    if name == "flagship":
        assert [r for _, r, _ in levels[:3]] == [
            128 // n_micro * 2 ** i for i in range(3)], levels
    if name == "area_random":
        assert float(got[1]["alight_intensity"].abs().sum()) > 0


def pose_loss(graphs, n_micro, remat):
    """The image MSE over the eye of mesh_grad's opaque scene (rays made
    by the differentiable camera from an eye that requires grad), with the
    scene's tables as parameters too: (loss, grads + the eye's)."""
    _, cam = scenes.mesh_grad(False, 32, 24)
    sc = case_pose_scene()
    target = torch.as_tensor(np.random.default_rng(1).uniform(
        0, 1, (32 * 24, 3)), dtype=torch.float32)
    eye = torch.tensor(scenes.GRAD_EYE, requires_grad=True)
    inv = torch.linalg.inv(view_transform_tensor(eye, scenes.GRAD_TO,
                                                 scenes.GRAD_UP))
    o, d = ray_grid_tensor(inv, cam.hsize, cam.vsize, cam.field_of_view)
    params, recombine = partition_scene(sc)
    loss, grads = render_loss_and_grad(params, recombine, o, d, target,
                                       n_micro=n_micro, remat=remat,
                                       graphs=graphs)
    assert o.requires_grad and eye.grad is not None
    return loss, {**grads, "eye": eye.grad}, None


@functools.cache
def case_pose_scene():
    items, _ = scenes.mesh_grad(False, 32, 24)
    return build_scene(items, recursion_limit=2, device="cpu")


@pytest.mark.parametrize("n_micro,remat", [(1, False), (2, True)])
def test_pose_through_rays_equals_eager(n_micro, remat):
    got = pose_loss(True, n_micro, remat)
    want = pose_loss(False, n_micro, remat)
    assert_equal(got, want)
    assert float(got[1]["eye"].abs().sum()) > 0
    assert TPG.programs()[0].ray_grad == (True, True)


def test_train_step_and_adam_equal_eager():
    """train_step's updated tables (n_micro 2), then make_optim_step's Adam
    over three steps (the material and light tables): graphed and eager
    give the same losses and tables bit for bit."""
    sc, o, d, target, _ = case("flagship")
    (l0, s0), (l1, s1) = (train_step(sc, o, d, target, lr=0.05, n_micro=2,
                                     remat=False, graphs=g)
                          for g in (True, False))
    assert torch.equal(l0, l1)
    p0, p1 = partition_scene(s0)[0], partition_scene(s1)[0]
    for k in p1:
        assert torch.equal(p0[k], p1[k]), k
    assert not torch.equal(p0["mat"], partition_scene(sc)[0]["mat"])

    runs = []
    for graphs in (True, False):
        init_fn, step_fn = make_optim_step(
            functools.partial(torch.optim.Adam, lr=1e-2),
            param_filter=lambda k: k in ("mat", "plight_intensity", "cyl_min"),
            graphs=graphs)
        state, s, losses = init_fn(sc), sc, []
        for _ in range(3):
            loss, s, state = step_fn(s, state, o, d, target)
            losses.append(loss)
        runs.append((losses, s, state))
    (la, sa, (opt_a, _)), (lb, sb, (opt_b, _)) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert float(la[-1]) < float(la[0])
    for k in ("mat", "plight_intensity", "cyl_min"):
        assert torch.equal(getattr(sa, k), getattr(sb, k)), k
    # cyl_min (no cylinder: an empty table) takes no gradient on either
    # side, so Adam keeps no state for it
    assert len(opt_a.state) == len(opt_b.state) == 2


def test_second_step_reuses_program(monkeypatch):
    """train_step makes a new Scene every step; the second step finds the
    first step's program, runs the keys it ran, makes no new buffer and
    calls torch.tensor / torch.as_tensor on no numpy array or sequence."""
    sc, o, d, target, _ = case("mesh_glass")
    TPG.drop_programs()
    _, sc1 = train_step(sc, o, d, target, lr=0.05, remat=False)
    (prog,) = TPG.programs()
    keys, bufs = set(prog.graphs), dict(prog.bufs)
    syncs = prog.stats["syncs"]
    uploads = []
    for fn in ("tensor", "as_tensor"):
        real = getattr(torch, fn)

        def spy(data, *a, _real=real, _fn=fn, **kw):
            if isinstance(data, (np.ndarray, list, tuple)):
                uploads.append((_fn, type(data).__name__))
            return _real(data, *a, **kw)

        monkeypatch.setattr(torch, fn, spy)
    _, sc2 = train_step(sc1, o, d, target, lr=0.05, remat=False)
    monkeypatch.undo()
    assert sc2 is not sc1 and sc1 is not sc
    assert TPG.programs() == [prog]
    assert set(prog.graphs) == keys and len(keys) >= 2 * 2 + 1
    assert prog.bufs.keys() == bufs.keys()
    assert all(prog.bufs[k] is v for k, v in bufs.items())
    assert uploads == []
    assert prog.stats["syncs"] == 2 * syncs
    assert prog.stats["captured"] == 0        # no capture on the CPU
    # another remat setting is another program
    train_step(sc2, o, d, target, lr=0.05, remat=True)
    assert len(TPG.programs()) == 2 and TPG.programs()[1] is prog


def test_forward_twice_before_backward_raises():
    sc, o, d, target, _ = case("flagship")
    params, recombine = partition_scene(sc)
    prog = TPG.program_for(params, recombine, o.shape[0], remat=False,
                           ray_grad=(False, False))
    prog.load(params)
    loss = prog.forward(o, d, target).clone()
    with pytest.raises(RuntimeError, match="before the backward"):
        prog.forward(o.flip(0), d.flip(0), target)
    grads, rays = prog.backward()
    assert rays == (None, None)
    want_loss, want = render_loss_and_grad(params, recombine, o, d, target,
                                           remat=False, graphs=False)
    assert torch.equal(loss, want_loss)
    for k, g in want.items():
        assert torch.equal(torch.zeros_like(g) if grads[k] is None
                           else grads[k], g), k
    with pytest.raises(RuntimeError, match="without a pending forward"):
        prog.backward()


def test_graphed_train_step_matches_jax():
    """The graphed train_step (remat on, the default) on
    test_torch_train.py's small scene against the JAX package's op-by-op
    value_and_grad of render_loss and its SGD update."""
    o, d = small_rays()
    target = torch.full((o.shape[0], 3), 0.3)
    js, ps = same_tables(small_items())
    jp, jr = jax_partition(js)
    j_loss, j_grads = jax.value_and_grad(jax_render_loss)(
        jp, jr, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(target.numpy()), None, remat=False)
    lr = 0.05
    loss, new = train_step(ps, o, d, target, lr=lr)
    assert TPG.programs()[0].remat
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    got = partition_scene(new)[0]
    assert set(got) == set(jp)
    for k in jp:
        want = np.asarray(jp[k]) - lr * np.asarray(j_grads[k])
        np.testing.assert_allclose(got[k].numpy(), want, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert float(np.abs(np.asarray(j_grads["mat"])).sum()) > 0
