"""The benchmark's walk reference (``rtbench/reference/walk.py``) on the
CPU: the port's frames of a small glass-mesh scene against it, within the
glass.frame cell's limit; the reference equal bit for bit to
``rtbench/reference/tracer.py`` on the scenes that tracer.py renders; its
n1/n2 walk over every triangle crossing against the dense per-triangle
walk of the JAX package (``test_mesh_refraction.dense_walk``) on rays
that start inside a glass tri-cube; and the "no behind column" fault,
which fails the limit. The reference is imported directly, not through the
benchmark's harness (which refuses to run with JAX loaded)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rtbench.control_walk import planted  # noqa: E402
from rtbench.harness import common  # noqa: E402
from rtbench.loops.frame import px_off  # noqa: E402
from rtbench.reference import tracer, walk  # noqa: E402
from rtbench.tests import tiny  # noqa: E402

from raytracer_tpu_torch.core.render import render  # noqa: E402

CONFIGS = common.BENCH_DIR / "configs"
LIMIT = json.loads((common.BENCH_DIR / "checks" / "glass.frame.json")
                   .read_text())["px_off"]
SEED = 2 ** 31 + 77


def config(name, size, instances=None):
    cfg = common.load_json(CONFIGS / f"{name}.json")
    cfg["camera"]["hsize"], cfg["camera"]["vsize"] = size
    tiny.cut_mesh(cfg)
    if instances is not None:
        cfg["instances"]["count"] = instances
    return cfg, common.load_module(CONFIGS / f"{name}.py")


@pytest.fixture(scope="module")
def glass():
    """4 instances of a 15 x 24-ring mesh at 48x27: (cfg, module, desc,
    the walk reference's frame)."""
    cfg, mod = config("glass", (48, 27), instances=4)
    desc = mod.describe(cfg, SEED)
    return cfg, mod, desc, walk.render_u8(walk.Scene(desc))


def port_frame(glass, tmp_path, graphs=True, fault=None):
    cfg, mod, desc, _ = glass
    with planted(fault):
        cam, scene = mod.port_scene(cfg, desc, tmp_path, "cpu")
        return render(scene, cam, quantize=True, graphs=graphs)


@pytest.mark.parametrize("graphs", [True, False], ids=["program", "eager"])
def test_port_frame_within_the_limit_of_the_walk(glass, tmp_path, graphs):
    frame = port_frame(glass, tmp_path, graphs)
    assert frame.shape == (27, 48, 3) and frame.std() > 5
    assert px_off(frame, glass[3]) <= LIMIT


def test_the_no_behind_column_fault_fails_the_limit(glass, tmp_path):
    assert px_off(port_frame(glass, tmp_path, fault="no_behind"),
                  glass[3]) > LIMIT


@pytest.mark.parametrize("name, size", [("flagship", (48, 27)),
                                        ("dragons", (48, 20))])
def test_walk_equals_tracer_where_tracer_renders(name, size):
    cfg, mod = config(name, size)
    desc = mod.describe(cfg, SEED)
    want = tracer.render_u8(tracer.Scene(desc))
    np.testing.assert_array_equal(walk.render_u8(walk.Scene(desc)), want)


def test_tracer_refuses_what_walk_renders(glass):
    with pytest.raises(NotImplementedError):
        tracer.Scene(glass[2])
    assert glass[3].std() > 5


def test_walk_indices_equal_the_dense_walk_inside_a_tri_cube():
    """Rays from inside the glass tri-cube (RI 1.5, beside a sphere of RI
    1.3 and under a plane) in every direction: n1 and n2 of walk.py's walk
    over the whole line's crossings equal the JAX package's generic walk
    over dense per-triangle columns, and inside the cube both are 1.5."""
    import jax.numpy as jnp
    from test_mesh_refraction import GLASS, dense_walk, glass_scene, tri_cube

    p = np.array([[t.p1, t.p2, t.p3] for t in tri_cube(GLASS)], np.float64)
    face = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    face /= np.linalg.norm(face, axis=-1, keepdims=True)
    desc = dict(
        camera={}, lights=[dict(position=(-10, 10, -10))],
        materials=[tracer.material(color=(0.8, 0.2, 0.2), specular=0.0),
                   tracer.material(transparency=0.9, refractive_index=1.3),
                   tracer.material(transparency=1.0, refractive_index=1.5)],
        shapes=[dict(kind="plane", transform=np.array(
                    [[1, 0, 0, 0], [0, 1, 0, -3.0], [0, 0, 1, 0],
                     [0, 0, 0, 1]]), material=0),
                dict(kind="sphere", transform=np.array(
                    [[1, 0, 0, 5.0], [0, 1, 0, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1]]), material=1)],
        meshes=[dict(p=p, n=np.repeat(face[:, None], 3, 1))],
        instances=[dict(mesh=0, transform=np.eye(4), material=2)])
    rng = np.random.default_rng(11)
    n = 512
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    has, n1, n2 = walk.refraction_indices(
        walk.Scene(desc), torch.as_tensor(o), torch.as_tensor(d))
    has_j, _, _, n1_j, n2_j = dense_walk(glass_scene(), jnp.asarray(o),
                                         jnp.asarray(d))
    np.testing.assert_array_equal(has.numpy(), np.asarray(has_j))
    assert has.all()
    np.testing.assert_array_equal(n1.numpy(), np.asarray(n1_j))
    np.testing.assert_array_equal(n2.numpy(), np.asarray(n2_j))
    np.testing.assert_array_equal(n1.numpy(), 1.5)
