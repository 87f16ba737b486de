"""Shared helpers of the tests that hold raytracer_tpu_torch against the
JAX package: the same specs through both builders, the same tables
through both renderers."""

import dataclasses

import numpy as np

from raytracer_tpu import camera as JC
from raytracer_tpu.scene import specs as JS
from raytracer_tpu.scene.builder import build_scene as jax_build_scene
from raytracer_tpu_torch.core.types import ARRAY_FIELDS, scene_from_arrays


def to_jax_specs(x):
    """Port spec objects (dataclasses, lists of them) -> the JAX package's
    spec classes of the same names and fields."""
    if isinstance(x, list):
        return [to_jax_specs(v) for v in x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(JS, type(x).__name__)
        return cls(**{f.name: to_jax_specs(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
    return x


def jax_camera(cam):
    return JC.Camera(cam.hsize, cam.vsize, cam.field_of_view, cam.transform)


def jax_arrays(jscene):
    """A JAX Scene's tables as numpy (None stays None)."""
    return {k: None if getattr(jscene, k) is None
            else np.asarray(getattr(jscene, k)) for k in ARRAY_FIELDS}


def same_tables(items, **build_kw):
    """(JAX scene, port scene on the CPU built from the JAX tables)."""
    js = jax_build_scene(to_jax_specs(items), **build_kw)
    ps = scene_from_arrays(jax_arrays(js), dataclasses.asdict(js.static),
                           "cpu")
    return js, ps


def unit_rays(rng, n, center=(0.0, 0.0, -5.0), spread=1.0, aim=(0, 0, 1.0),
              jitter=0.3):
    """n rays (numpy f32) from around ``center`` towards ``aim``."""
    o = rng.uniform(-spread, spread, (n, 3)) + np.asarray(center)
    d = rng.normal(0, jitter, (n, 3)) + np.asarray(aim)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def assert_grads_match(got, want, rtol=1e-4, atol=1e-6, loose=None):
    """Every gradient table of ``want`` (JAX) matches ``got`` (the port)
    within rtol/atol, except at most ``loose[k] = (n, atol_k)`` entries of
    table k, which must be within ``atol_k``."""
    loose = loose or {}
    for k in sorted(want):
        a = np.asarray(want[k])
        b = got[k].detach().cpu().numpy() if hasattr(got[k], "detach") \
            else np.asarray(got[k])
        assert a.shape == b.shape, k
        assert np.isfinite(b).all(), k
        n, atol_k = loose.get(k, (0, atol))
        off = ~np.isclose(b, a, rtol=rtol, atol=atol)
        assert off.sum() <= n, (k, int(off.sum()))
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol_k, err_msg=k)


def mesh_row(scene):
    """The material row of a scene's (first) mesh."""
    g = sum(scene.static.counts[:5])
    return int(scene.mat_id[g + int(scene.tri_tf_id[0])])


def assert_same_tables(jscene, pscene, skip_mesh=True):
    """A JAX scene and a port scene hold the same static facts and the same
    tables, exactly (the mesh kernel's packed planes are left out unless
    ``skip_mesh`` is False: the JAX builder packs only 1024+ free
    triangles)."""
    assert dataclasses.asdict(pscene.static) == dataclasses.asdict(
        jscene.static)
    ja = jax_arrays(jscene)
    for k in ARRAY_FIELDS:
        if skip_mesh and k.startswith("mesh_"):
            continue
        a, b = ja[k], getattr(pscene, k)
        assert (a is None) == (b is None), k
        if a is None:
            continue
        b = b.cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
