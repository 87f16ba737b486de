"""The mesh query's gradient in raytracer_tpu_torch, alone and under finite
differences.

``ops.mesh_cuda.MeshNearest`` runs the mesh query forward (the kernel on
cuda, the plain version here) and recomputes the winning triangle's
Moller-Trumbore backward. On random soups its gradients are held against
``jax.grad`` through the JAX package's scan path
(``intersect._tri_free_nearest_scan``), which differentiates the chunked
brute force op by op; both packages read the same tables
(``scene_from_arrays``) and the same rays, made with numpy from a seed.
Bounds: rtol 1e-4, atol 1e-6, except a few per-triangle sums, counted and
explained in test_mesh_nearest_grad_matches_jax_scan. The scene-level
comparisons with JAX are in test_torch_mesh_grad.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import intersect as JI
from raytracer_tpu_torch import scenes
from raytracer_tpu_torch.camera import ray_grid_tensor, view_transform_tensor
from raytracer_tpu_torch.core import intersect as I
from raytracer_tpu_torch.core.render import PARK_DIR, PARK_ORIGIN, color_at
from raytracer_tpu_torch.parallel.train import (
    partition_scene, render_loss_and_grad)
from raytracer_tpu_torch.scene import build_scene, specs as S
from torch_port_helpers import assert_grads_match, mesh_row, same_tables

TRI_KEYS = ("tri_p1", "tri_e1", "tri_e2")


def soup_items(n=700, seed=5):
    """A random triangle soup of ``n`` triangles in [-2, 2]^2 x [0, 4]."""
    rng = np.random.default_rng(seed)
    c = rng.uniform((-2, -2, 0), (2, 2, 4), (n, 1, 3))
    p = (c + rng.normal(0, 0.4, (n, 3, 3))).astype(np.float32)
    return [S.Mesh(p=p, n=np.zeros_like(p), smooth=np.zeros(n, bool))]


def soup_rays(rng, n):
    """n rays from z = -3 towards the soup: a third aimed off to the side
    (they miss), and every 17th parked as render.park_rays parks them."""
    o = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                        np.full((n, 1), -3.0)], 1)
    d = rng.normal(0, 0.15, (n, 3)) + (0.0, 0.0, 1.0)
    d[: n // 3] = rng.normal(0, 0.1, (n // 3, 3)) + (3.0, 0.0, 0.2)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[::17], d[::17] = PARK_ORIGIN, PARK_DIR
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("reverse", [False, True], ids=["nearest", "reverse"])
def test_mesh_nearest_grad_matches_jax_scan(reverse):
    """sum(a.t + b.u + c.v) over the query's hits: the gradients with
    respect to origins, directions and the triangle rows equal jax.grad
    through the scan path. 300 rays (padded to 512 for the kernel's
    subtiles), caps on half of them in nearest mode; reverse mode is the
    nearest query on (o, -d), which the behind column runs."""
    js, ps = same_tables(soup_items())
    nt = js.static.counts[5]
    rng = np.random.default_rng(11 + reverse)
    r = 300
    o, d = soup_rays(rng, r)
    if reverse:                   # reversed rays point back at the soup
        o[:, 2] = 7.0
    cap = None
    if not reverse:
        cap = np.where(np.arange(r) % 2 == 0, rng.uniform(3.0, 8.0, r),
                       np.inf).astype(np.float32)
    a, b, c = (rng.normal(0, 1, r).astype(np.float32) for _ in range(3))

    def jax_loss(o_, d_, p1, e1, e2):
        sc = js.__class__(**{**{k: getattr(js, k) for k in js.__dataclass_fields__},
                             "tri_p1": p1, "tri_e1": e1, "tri_e2": e2})
        t, _, u, v = JI._tri_free_nearest_scan(
            sc, o_, -d_ if reverse else d_, 0, nt,
            t_cap=None if cap is None else jnp.asarray(cap))
        hit = jnp.isfinite(t)
        t = jnp.where(hit, t, 0.0)
        return jnp.sum(jnp.where(hit, a * t + b * u + c * v, 0.0))

    want = jax.grad(jax_loss, argnums=range(5))(
        jnp.asarray(o), jnp.asarray(d), js.tri_p1, js.tri_e1, js.tri_e2)

    params, recombine = partition_scene(ps, include_geometry=True)
    leaves = {k: params[k].detach().requires_grad_(True) for k in TRI_KEYS}
    scene = recombine({**params, **leaves})
    ot = torch.tensor(o, requires_grad=True)
    dt = torch.tensor(d, requires_grad=True)
    t, _, u, v = I._mesh_query(scene, ot, dt,
                               None if cap is None else torch.tensor(cap),
                               False, reverse)
    hit = torch.isfinite(t)
    t = torch.where(hit, t, 0.0)
    loss = torch.where(hit, torch.tensor(a) * t + torch.tensor(b) * u
                       + torch.tensor(c) * v, 0.0).sum()
    loss.backward()
    got = dict(o=ot.grad, d=dt.grad, **{k: leaves[k].grad for k in TRI_KEYS})
    # A triangle's gradient sums the terms of the rays it is the winner
    # of, in another order in each package; where terms of size ~1 cancel,
    # f32 rounding shows past rtol 1e-4 on the small sum: at most 3 entries
    # of each 2,100-entry table, within 5e-5 (nearest mode: 2 of tri_e1,
    # 1 of tri_e2; reverse mode: none).
    assert_grads_match(got, dict(zip(["o", "d"] + list(TRI_KEYS), want)),
                       loose={k: (3, 5e-5) for k in TRI_KEYS})

    # the rays without a hit (parked ones among them) get exactly 0
    miss = ~hit.numpy()
    assert miss[::17].all() and miss.sum() > r // 3 - 10 and (~miss).sum() > 50
    assert (ot.grad.numpy()[miss] == 0.0).all()
    assert (dt.grad.numpy()[miss] == 0.0).all()


def test_mesh_nearest_grad_is_zero_without_hits():
    """A batch where no ray hits (parked, aimed away, and the padding to
    the subtile): every gradient is exactly 0, none NaN, triangle 0 (which
    the missed rays' recompute reads) included."""
    _, ps = same_tables(soup_items(70))
    rng = np.random.default_rng(2)
    o, d = soup_rays(rng, 100)
    d[:] = (1.0, 0.0, 0.0)
    o[::3], d[::3] = PARK_ORIGIN, PARK_DIR
    params, recombine = partition_scene(ps, include_geometry=True)
    leaves = {k: params[k].detach().requires_grad_(True) for k in TRI_KEYS}
    ot = torch.tensor(o, requires_grad=True)
    dt = torch.tensor(d, requires_grad=True)
    t, _, u, v = I._mesh_query(recombine({**params, **leaves}), ot, dt, None,
                               False, False)
    assert not torch.isfinite(t).any()
    (torch.where(torch.isfinite(t), t, 0.0) + u + v).sum().backward()
    for g in [ot.grad, dt.grad] + [leaves[k].grad for k in TRI_KEYS]:
        assert torch.equal(g, torch.zeros_like(g))


def test_mesh_material_grad_matches_finite_differences():
    """Central differences on the glass mesh's ambient and diffuse entries
    of ``mat`` (the bounds of tests/test_grad_parallel.py:59), 24x16,
    depth 2. The sphere's RI is held to JAX in test_torch_mesh_grad.py but
    not here: moving refracted rays carries them across checker edges and
    silhouettes, jumps that no gradient sees."""
    h, v = 24, 16
    ps = build_scene(scenes.mesh_grad(True, h, v)[0], recursion_limit=2,
                     device="cpu")
    params, recombine = partition_scene(ps)
    inv = torch.linalg.inv(view_transform_tensor(
        scenes.GRAD_EYE, scenes.GRAD_TO, scenes.GRAD_UP))
    o, d = ray_grid_tensor(inv, h, v, scenes.GRAD_FOV)
    tgt = torch.tensor(np.random.default_rng(0).uniform(0, 1, (h * v, 3)),
                       dtype=torch.float32)
    _, grads = render_loss_and_grad(params, recombine, o, d, tgt)
    row, eps = mesh_row(ps), 1e-3

    def loss_at(row, col, delta):
        mat = params["mat"].clone()
        mat[row, col] += delta
        with torch.no_grad():
            img = color_at(recombine({**params, "mat": mat}), o, d)
        return float(torch.mean((img - tgt) ** 2))

    for col in (3, 4):                             # ambient, diffuse
        num = (loss_at(row, col, eps) - loss_at(row, col, -eps)) / (2 * eps)
        ana = float(grads["mat"][row, col])
        assert abs(ana - num) < 5e-3 * max(1.0, abs(num)), (col, ana, num)
        assert abs(ana) > 1e-5, (row, col, ana)
