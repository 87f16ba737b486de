"""Public names of the JAX package that the port carries too, each held
against the JAX function on the same inputs: ``camera.ray_for_pixel``,
``core.intersect.sorted_hits`` (the book-value test oracle),
``Scene.family_slice`` and the lazy ``scene.parse_scene`` alias.

Exact where the JAX side is exact; sorted_hits' t to 1e-5 relative, as
the candidate tables are held in tests/test_torch_intersect_shading.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu.scene as JSC
from raytracer_tpu import camera as JC
from raytracer_tpu.core import intersect as JI
from raytracer_tpu_torch import camera as C
from raytracer_tpu_torch import scenes
from raytracer_tpu_torch import scene as SC
from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.core import intersect as I
from raytracer_tpu_torch.core.types import FAMILIES
from raytracer_tpu_torch.scene import specs as S
from raytracer_tpu_torch.scenes import revolved_mesh
from torch_port_helpers import (assert_same_tables, jax_camera, same_tables,
                                unit_rays)


@pytest.mark.parametrize("px,py", [(0, 0), (100, 50), (5, 7), (200, 99)])
def test_ray_for_pixel_matches_jax(px, py):
    cam = C.Camera(201, 101, math.pi / 2).with_transform(
        tf.view_transform((1.0, 1.5, -5.0), (0.0, 1.0, 0.0),
                          (0.0, 1.0, 0.0)))
    o, d = C.ray_for_pixel(cam, px, py)
    jo, jd = JC.ray_for_pixel(jax_camera(cam), px, py)
    assert o.dtype == np.float32 and o.shape == (3,)
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(d, jd)


def _hit_items():
    """Spheres, a cube, a plane and a transparent mesh instance: the
    candidate table has the nearest and the behind mesh columns."""
    p, n, smooth = revolved_mesh()
    glass = S.Material(transparency=0.9, refractive_index=1.5)
    return [
        S.PointLight(position=(-10, 10, -10)),
        S.Sphere(material=S.Material(color=(0.8, 1.0, 0.6), diffuse=0.7,
                                     specular=0.2)),
        S.Sphere(transform=tf.scaling(0.5, 0.5, 0.5)),
        S.Cube(transform=tf.translation(2, 0, 1) @ tf.rotation_y(0.4)),
        S.Plane(transform=tf.translation(0, -2, 0)),
        S.Group(transform=tf.translation(-0.5, -1, 0.5)
                @ tf.scaling(0.06, 0.06, 0.06), children=[
                    S.Mesh(p=p, n=n, smooth=smooth, material=glass)]),
    ]


@pytest.fixture(scope="module")
def hit_case():
    js, ps = same_tables(_hit_items())
    rng = np.random.default_rng(4)
    o1, d1 = unit_rays(rng, 200, center=(0, 0, -6), spread=0.8,
                       aim=(0, 0, 1), jitter=0.3)
    o2, d2 = unit_rays(rng, 200, center=(0, -1, 1.0), spread=1.0,
                       aim=(0, 0, 0), jitter=1.0)
    return js, ps, np.concatenate([o1, o2]), np.concatenate([d1, d2])


@pytest.mark.parametrize("k", [12, 3])
def test_sorted_hits_matches_jax(hit_case, k):
    js, ps, o, d = hit_case
    want = [np.asarray(x) for x in
            JI.sorted_hits(js, jnp.asarray(o), jnp.asarray(d), k=k)]
    got = [x.numpy() for x in
           I.sorted_hits(ps, torch.as_tensor(o), torch.as_tensor(d), k=k)]
    for a, b in zip(want, got):
        assert a.shape == b.shape
    jt, pt = want[0], got[0]
    hit = np.isfinite(jt)
    assert (np.isfinite(pt) == hit).all()
    assert hit.sum() > 200 and not np.isneginf(pt).any()
    ascending = np.diff(np.where(hit, pt, np.float32(3e38)), axis=-1)
    assert (ascending >= 0).all()
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(got[1][hit], want[1][hit])


def test_family_slice_matches_jax():
    js, ps = same_tables(_hit_items())
    for fam in FAMILIES:
        for table in ("mat_id", "inv_tf", "shadow"):
            want = np.asarray(js.family_slice(fam, getattr(js, table)))
            got = ps.family_slice(fam, getattr(ps, table)).numpy()
            assert want.shape == got.shape, (fam, table)
            np.testing.assert_array_equal(got, want, err_msg=f"{fam} {table}")
    assert ps.family_slice("sphere", ps.inv_tf).shape[0] == 2


def test_parse_scene_alias_matches_jax():
    text = scenes.csg_area_yaml(32, 24)
    cam, ps = SC.parse_scene(text, jitter=(0.5,), device="cpu")
    jcam, js = JSC.parse_scene(text, jitter=(0.5,))
    assert (cam.hsize, cam.vsize) == (jcam.hsize, jcam.vsize)
    assert cam.field_of_view == jcam.field_of_view
    np.testing.assert_array_equal(cam.transform, np.asarray(jcam.transform))
    assert_same_tables(js, ps)
