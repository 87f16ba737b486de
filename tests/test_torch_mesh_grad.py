"""Gradients of mesh scenes through raytracer_tpu_torch against the JAX
package.

The 6,320-triangle ``scenes.mesh_grad`` scene, opaque and glass, depth 2,
24x16: the port's loss and gradients (the mesh query's backward is
``ops.mesh_cuda.MeshNearest``, a recompute of the winning triangle)
against ``jax.value_and_grad`` of the JAX package's render, whose mesh
queries run the scan path (``intersect._tri_free_nearest_scan``). Both
packages read the same tables (``scene_from_arrays``); the JAX side runs
op by op, not jitted (jit rounds a few edge pixels differently, ROADMAP
F5), and its two calls set this file's time. Bounds: losses to rtol 1e-5,
every gradient table to rtol 1e-4, atol 1e-6; no looser bound is needed.
MeshNearest alone and finite differences: test_torch_mesh_query_grad.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import torch

from raytracer_tpu.camera import ray_grid_jax, view_transform_jax
from raytracer_tpu.core.render import color_at as jax_color_at
from raytracer_tpu.parallel.train import partition_scene as jax_partition
from raytracer_tpu_torch import scenes
from raytracer_tpu_torch.camera import ray_grid_tensor, view_transform_tensor
from raytracer_tpu_torch.core.render import color_at
from raytracer_tpu_torch.parallel.train import partition_scene
from torch_port_helpers import assert_grads_match, mesh_row, same_tables

H, V = 24, 16
EYE, TO, UP, FOV = (scenes.GRAD_EYE, scenes.GRAD_TO, scenes.GRAD_UP,
                    scenes.GRAD_FOV)
TRI_KEYS = ("tri_p1", "tri_e1", "tri_e2")


def target_image(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (H * V, 3)).astype(
        np.float32)


def jax_eye_loss_and_grads(js, include_geometry):
    """JAX op by op: (loss, d loss / d eye, d loss / d params) of the image
    MSE, the rays made by ray_grid_jax from the eye."""
    params, recombine = jax_partition(js, include_geometry=include_geometry)
    tgt = jnp.asarray(target_image())

    def loss(eye, p):
        inv = jnp.linalg.inv(view_transform_jax(eye, jnp.asarray(TO),
                                                jnp.asarray(UP)))
        o, d = ray_grid_jax(inv, H, V, FOV)
        return jnp.mean((jax_color_at(recombine(p), o, d) - tgt) ** 2)

    val, (g_eye, g_p) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(EYE, jnp.float32), params)
    return float(val), np.asarray(g_eye), g_p


def port_eye_loss_and_grads(ps, include_geometry):
    params, recombine = partition_scene(ps, include_geometry=include_geometry)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    eye = torch.tensor(EYE, requires_grad=True)
    inv = torch.linalg.inv(view_transform_tensor(eye, TO, UP))
    o, d = ray_grid_tensor(inv, H, V, FOV)
    loss = torch.mean((color_at(recombine(leaves), o, d)
                       - torch.tensor(target_image())) ** 2)
    loss.backward()
    grads = {k: torch.zeros_like(v) if v.grad is None else v.grad
             for k, v in leaves.items()}
    return float(loss.detach()), eye.grad, grads


def test_opaque_mesh_eye_and_geometry_grads_match_jax():
    """The reflective opaque mesh, depth 2, rays from the eye through the
    differentiable camera: the eye's gradient (the mesh query's backward
    at level 0 on every ray) and, with include_geometry, every float
    table's, tri_p1/tri_e1/tri_e2 and inv_tf included."""
    js, ps = same_tables(scenes.mesh_grad(False, H, V)[0], recursion_limit=2)
    assert js.static.counts[5] == 6320 and js.static.all_ri_one
    j_loss, j_eye, j_grads = jax_eye_loss_and_grads(js, True)
    p_loss, p_eye, p_grads = port_eye_loss_and_grads(ps, True)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-5)
    assert set(p_grads) == set(j_grads)
    assert set(TRI_KEYS) <= set(p_grads)
    assert_grads_match({"eye": p_eye, **p_grads}, {"eye": j_eye, **j_grads})
    for k in TRI_KEYS:             # the mesh query's backward reached them
        assert int((p_grads[k] != 0).any(-1).sum()) > 50, k


def test_glass_mesh_mat_grads_match_jax():
    """The glass mesh behind a glass sphere: the n1/n2 walk reads the
    behind column, and the rays the sphere refracts depend on its RI entry
    of ``mat``, so level 1's mesh queries take a gradient. Default grad
    surface, plus the eye."""
    js, ps = same_tables(scenes.mesh_grad(True, H, V)[0], recursion_limit=2)
    assert js.static.mesh_transparent and js.static.mesh_uniform_refr == 1.5
    j_loss, j_eye, j_grads = jax_eye_loss_and_grads(js, False)
    p_loss, p_eye, p_grads = port_eye_loss_and_grads(ps, False)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-5)
    assert set(p_grads) == set(j_grads)
    assert_grads_match({"eye": p_eye, **p_grads}, {"eye": j_eye, **j_grads})
    sphere = ps.static.family_range("sphere")[0]
    assert float(p_grads["mat"][int(ps.mat_id[sphere]), 9].abs()) > 1e-6
    assert float(p_grads["mat"][mesh_row(ps), 9]) == 0.0   # a constant
