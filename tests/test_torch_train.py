"""The training path of raytracer_tpu_torch (``parallel/train.py``) against
the JAX package's ``raytracer_tpu/parallel/train.py``.

Both packages read the same tables (``scene_from_arrays``) and the same
rays; the JAX side runs ``jax.value_and_grad`` op by op, not jitted (jit
rounds a few edge pixels differently, ROADMAP F5). Bounds: losses to rtol
1e-5, every gradient table to rtol 1e-4, atol 1e-6; none needs a looser
one. Port-only properties (remat, microbatches, the seeded jitter replay,
optimizers, poses) are checked on the port alone.
"""

import dataclasses
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
from raytracer_tpu_torch.camera import Camera, ray_grid
from raytracer_tpu_torch.core.render import color_at
from raytracer_tpu_torch.core.types import ARRAY_FIELDS
from raytracer_tpu_torch.parallel import (
    DERIVED_GEOMETRY, make_optim_step, partition_scene, render_loss,
    render_loss_and_grad, train_step, with_prim_transform)
from raytracer_tpu_torch.scene import build_scene, specs as S
from torch_port_helpers import same_tables

RTOL, ATOL = 1e-4, 1e-6


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


def area_items():
    """A 2x2 area light over a reflective sphere and a plane."""
    return [
        S.AreaLight(corner=(-3.0, 6.0, -4.0), uvec=(2.0, 0.0, 0.0), usteps=2,
                    vvec=(0.0, 0.0, 2.0), vsteps=2),
        S.Plane(material=S.Material(specular=0.0)),
        S.Sphere(transform=tf.translation(-0.3, 1.0, 0.5),
                 material=S.Material(color=(0.9, 0.4, 0.1), diffuse=0.7,
                                     reflective=0.3)),
    ]


def target_for(o, value=0.3):
    return torch.full((o.shape[0], 3), value)


def assert_tables_close(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in sorted(want):
        a = np.asarray(want[k])
        b = got[k].detach().cpu().numpy()
        assert a.shape == b.shape, k
        assert np.isfinite(b).all(), k
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k)


def port_vs_jax(items, o, d, target, remats=(False,), **build_kw):
    """(loss, grads) of render_loss in both packages, the port with each
    ``remat`` of ``remats`` against one op-by-op JAX value_and_grad."""
    js, ps = same_tables(items, **build_kw)
    jp, jr = jax_partition(js)
    j_loss, j_grads = jax.value_and_grad(jax_render_loss)(
        jp, jr, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(target.numpy()), None, remat=False)
    pp, pr = partition_scene(ps)
    for remat in remats:
        p_loss, p_grads = render_loss_and_grad(pp, pr, o, d, target,
                                               remat=remat)
        np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-5)
        assert_tables_close(p_grads, j_grads)
    return p_grads


# -------------------------------------------------------------- partition

@pytest.mark.parametrize("include_geometry", [False, True])
def test_partition_scene_matches_jax(include_geometry):
    """The same parameter keys, shapes and values as the JAX package's
    partition of the same specs (a mesh scene, so the packed mesh tables
    are among the derived ones), and recombine gives the scene back."""
    items = small_items() + [S.Mesh(
        p=np.random.default_rng(0).normal(0, 1, (1100, 3, 3)).astype(
            np.float32),
        n=np.zeros((1100, 3, 3), np.float32), smooth=np.zeros(1100, bool))]
    js, ps = same_tables(items)
    jp, _ = jax_partition(js, include_geometry=include_geometry)
    pp, recombine = partition_scene(ps, include_geometry=include_geometry)
    assert set(pp) == set(jp)
    assert bool(set(pp) & DERIVED_GEOMETRY) == include_geometry
    for k in jp:
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
    back = recombine(pp)
    assert back.static == ps.static
    for k in ARRAY_FIELDS:
        a, b = getattr(back, k), getattr(ps, k)
        assert (a is None and b is None) or torch.equal(a, b), k


# --------------------------------------------------------- port vs JAX

def test_small_setup_grads_match_jax():
    o, d = small_rays()
    port_vs_jax(small_items(), o, d, target_for(o))


def test_flagship_grads_match_jax_with_and_without_remat():
    """The blend flagship (levels grow to 16R) at 16x8, depth 4: the port
    with remat off and on, each against the JAX gradients."""
    items, cam = scenes.flagship(16, 8)
    o, d = ray_grid(cam, device="cpu")
    port_vs_jax(items, o, d, target_for(o, 0.0), remats=(False, True))


def test_area_light_grads_match_jax():
    """Deterministic jitter (0.5,): the jitter tables are the JAX package's
    exactly, so the area light's gradients (intensity, material, the
    shadow-sampled Phong) match."""
    o, d = small_rays()
    grads = port_vs_jax(area_items(), o, d, target_for(o, 0.2),
                        jitter=(0.5,), recursion_limit=2)
    assert float(grads["alight_intensity"].abs().sum()) > 0.0


# ------------------------------------------------------------ port alone

def test_remat_matches_no_remat_with_seeded_jitter():
    """Seeded jitter: each level draws from an explicit torch.Generator,
    which checkpoint's recompute does not replay by itself. With the same
    generator seed, remat on and off must give the same loss and
    gradients, and leave the generator in the same state."""
    o, d = small_rays()
    sc = build_scene(area_items(), recursion_limit=2, device="cpu")
    params, recombine = partition_scene(sc)
    out = []
    for remat in (False, True):
        g = torch.Generator().manual_seed(7)
        loss, grads = render_loss_and_grad(params, recombine, o, d,
                                           target_for(o, 0.2), g, remat=remat)
        out.append((loss, grads, g.get_state()))
    (l0, g0, s0), (l1, g1, s1) = out
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    assert_tables_close(g1, {k: v.numpy() for k, v in g0.items()},
                        rtol=1e-5, atol=1e-7)
    assert torch.equal(s0, s1)
    assert float(g0["alight_intensity"].abs().sum()) > 0.0


def test_microbatches_match_full_batch():
    """n_micro=4 (remat on and off) updates the scene as the full batch
    does (tests/test_grad_parallel.py:229)."""
    o, d = small_rays()
    sc = build_scene(small_items(), device="cpu")
    target = target_for(o, 0.2)
    loss_a, sc_a = train_step(sc, o, d, target, lr=1e-3)
    for remat in (True, False):
        loss_b, sc_b = train_step(sc, o, d, target, lr=1e-3, n_micro=4,
                                  remat=remat)
        np.testing.assert_allclose(float(loss_b), float(loss_a), rtol=1e-5)
        want, _ = partition_scene(sc_a)
        got, _ = partition_scene(sc_b)
        assert_tables_close(got, {k: v.numpy() for k, v in want.items()},
                            rtol=1e-4, atol=1e-7)
    with pytest.raises(ValueError):
        train_step(sc, o, d, target, n_micro=3)


def test_train_step_reduces_loss():
    o, d = small_rays()
    sc = build_scene(small_items(), device="cpu")
    loss0, sc1 = train_step(sc, o, d, target_for(o), lr=0.005)
    loss1, _ = train_step(sc1, o, d, target_for(o), lr=0.005)
    assert float(loss1) < float(loss0)


def test_optim_step_adam_reduces_loss():
    """make_optim_step over torch.optim.Adam, the material table only
    (tests/test_grad_parallel.py:116): 5 steps lower the loss, and only
    ``mat`` moves."""
    o, d = small_rays()
    sc = build_scene(small_items(), device="cpu")
    target = target_for(o, 0.25)
    init_fn, step_fn = make_optim_step(
        functools.partial(torch.optim.Adam, lr=1e-2),
        param_filter=lambda k: k == "mat")
    state = init_fn(sc)
    loss0, sc2, state = step_fn(sc, state, o, d, target)
    for _ in range(4):
        loss, sc2, state = step_fn(sc2, state, o, d, target)
    assert float(loss) < float(loss0)
    assert not torch.equal(sc2.mat, sc.mat)
    assert torch.equal(sc2.plight_intensity, sc.plight_intensity)


def test_pose_gradient_matches_finite_differences():
    """with_prim_transform (tests/test_grad_parallel.py:309): the sphere's
    translation gradient matches central differences at a point where the
    +-eps window crosses no silhouette; a mesh gid raises."""
    items = [
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Plane(material=S.Material(specular=0.0)),
        S.Sphere(transform=tf.translation(0.0, 1.0, 0.0),
                 material=S.Material(color=(0.8, 0.2, 0.2), diffuse=0.7)),
    ]
    sc = build_scene(items, recursion_limit=1, device="cpu")
    gid = sc.static.family_range("sphere")[0]
    cam = Camera(48, 32, math.pi / 3).with_transform(
        tf.view_transform((0.0, 1.5, -5.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)))
    o, d = ray_grid(cam, device="cpu")
    with torch.no_grad():
        target = color_at(sc, o, d, limit=1)

    def loss(tx):
        m = torch.eye(4)
        m = m.index_put((torch.tensor([0]), torch.tensor([3])), tx[None])
        m = m.index_put((torch.tensor([1]), torch.tensor([3])),
                        torch.ones(1))
        img = color_at(with_prim_transform(sc, gid, m), o, d, limit=1)
        return torch.mean((img - target) ** 2)

    tx = torch.tensor(0.4, requires_grad=True)
    loss(tx).backward()
    eps = 1e-3
    with torch.no_grad():
        fd = float((loss(torch.tensor(0.4 + eps)) - loss(torch.tensor(0.4 - eps)))
                   / (2 * eps))
    g = float(tx.grad)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=0.15, atol=2e-4)

    mesh = build_scene(items + [S.Mesh(
        p=np.eye(3, dtype=np.float32)[None], n=np.zeros((1, 3, 3), np.float32),
        smooth=np.zeros(1, bool))], device="cpu")
    with pytest.raises(ValueError):
        with_prim_transform(mesh, sum(mesh.static.counts[:5]), torch.eye(4))


def test_render_loss_is_the_image_mse():
    o, d = small_rays()
    sc = build_scene(small_items(), device="cpu")
    params, recombine = partition_scene(sc)
    with torch.no_grad():
        img = color_at(sc, o, d)
        loss = render_loss(params, recombine, o, d, target_for(o))
    assert float(loss) == float(torch.mean((img - 0.3) ** 2))
    assert dataclasses.is_dataclass(recombine(params))
