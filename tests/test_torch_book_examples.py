"""The book API (``tuples.py``, ``matrices.py``) and the three scene
examples of raytracer_tpu_torch against the JAX package.

The tuples and matrices get tests/test_tuples_matrices.py's cases through
both packages (to 1e-6, relative for determinants) and a gradient. Each
example runs as a subprocess with ``--device cpu`` at 80x45; its P3 PPM
must be well formed and within the u8 frame budget (at most 0.5% of
pixels more than one step apart) of the JAX package's render of the same
specs, rendered in this process.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu import matrices as JM
from raytracer_tpu import tuples as JTU
from raytracer_tpu.core.render import render as jax_render
from raytracer_tpu.scene.builder import build_scene as jax_build_scene
from raytracer_tpu_torch import matrices as M
from raytracer_tpu_torch import tuples as TU
from raytracer_tpu_torch.examples import basic_scene, csg, example_camera, hexagon
from torch_port_helpers import jax_camera, to_jax_specs

REPO = Path(__file__).resolve().parent.parent
S2 = math.sqrt(2) / 2
V = [(1, 2, 3), (2, 3, 4), (4, 0, 0), (1, -1, 0), (0, 1, 0), (0, -1, 0),
     (S2, S2, 0), (4.3, -4.2, 3.1)]
M2 = [[1.0, 5.0], [-3.0, 2.0]]
M3 = [[1.0, 2.0, 6.0], [-5.0, 8.0, -4.0], [2.0, 6.0, 4.0]]
M3B = [[3.0, 5.0, 0.0], [2.0, -1.0, -7.0], [6.0, -1.0, 5.0]]
M4 = [[-2.0, -8.0, 3.0, 5.0], [-3.0, 1.0, 7.0, 3.0],
      [1.0, 2.0, -9.0, 6.0], [-6.0, 7.0, 7.0, -9.0]]
M4I = [[-5.0, 2.0, 6.0, -8.0], [1.0, -5.0, 1.0, 8.0],
       [7.0, 7.0, -6.0, -7.0], [1.0, -3.0, 7.0, 4.0]]


def same(got, want, rtol=1e-6, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_tuples_match_jax():
    for v in V:
        for ctor in ("point", "vector"):
            a, b = getattr(TU, ctor)(*v), getattr(JTU, ctor)(*v)
            same(a, b)
            assert TU.is_point(a) == JTU.is_point(b)
            assert TU.is_vector(a) == JTU.is_vector(b)
            same(TU.magnitude(a), JTU.magnitude(b))
            same(TU.normalize(a), JTU.normalize(b))
        same(TU.normalize(np.float32(v)), JTU.normalize(np.float32(v)))
        for w in V:
            a, b = TU.vector(*v), TU.vector(*w)
            ja, jb = JTU.vector(*v), JTU.vector(*w)
            same(TU.dot(a, b), JTU.dot(ja, jb))
            same(TU.cross(a, b), JTU.cross(ja, jb))
            same(TU.reflect(a, b), JTU.reflect(ja, jb))
    c1, c2 = (1, 0.2, 0.4), (0.9, 1, 0.1)
    same(TU.hadamard(TU.color(*c1), TU.color(*c2)),
         JTU.hadamard(JTU.color(*c1), JTU.color(*c2)))
    c = (1.5, 0.5, -0.5, 0.25, 0.998, 1 / 510)
    q = TU.to_u8(c)
    assert q.dtype == torch.uint8
    assert q.tolist() == np.asarray(JTU.to_u8(c)).tolist() == [
        255, 128, 0, 64, 254, 1]


def test_matrices_match_jax():
    for m in (M2, M3, M3B, M4, M4I):
        same(M.determinant(m), JM.determinant(m), rtol=1e-6, atol=0)
        same(M.transpose(m), JM.transpose(m))
        assert M.is_invertible(m) == JM.is_invertible(m)
        n = len(m)
        for r in range(n):
            for c in range(n):
                same(M.submatrix(m, r, c), JM.submatrix(m, r, c))
                if n > 1:
                    same(M.minor(m, r, c), JM.minor(m, r, c), atol=1e-4)
                    same(M.cofactor(m, r, c), JM.cofactor(m, r, c),
                         atol=1e-4)
    for m in (M4, M4I):
        same(M.inverse(m), JM.inverse(m), rtol=1e-5)
        same(M.mat_mul_tuple(m, TU.point(1, 2, 3)),
             JM.mat_mul_tuple(m, JTU.point(1, 2, 3)))
    same(M.identity(), JM.identity())
    assert not M.is_invertible([[0.0, 0.0], [0.0, 0.0]])
    # the book's oracles
    assert abs(float(M.determinant(M4)) + 4071.0) < 1e-2
    assert abs(float(M.cofactor(M3, 0, 2)) + 46.0) < 1e-4


def test_book_api_is_differentiable():
    x = torch.tensor(2.0, requires_grad=True)
    v = TU.vector(x, 1.0, 2.0)
    (TU.magnitude(v) + M.determinant(torch.stack([v[:2], v[1:3]]))).backward()
    # d/dx [sqrt(x^2 + 5) + (x * 2 - 1 * 1)] = x / 3 + 2
    np.testing.assert_allclose(float(x.grad), 2.0 / 3.0 + 2.0, rtol=1e-6)


def read_p3(data):
    body = data.split()
    assert body[0] == b"P3"
    w, h, maxval = int(body[1]), int(body[2]), int(body[3])
    px = np.array(body[4:], dtype=np.int32)
    assert px.size == w * h * 3 and (px >= 0).all() and (px <= maxval).all()
    return px.reshape(h, w, 3), maxval


@pytest.mark.parametrize("example", [basic_scene, csg, hexagon],
                         ids=["basic_scene", "csg", "hexagon"])
def test_example_matches_jax(example, monkeypatch):
    name = example.__name__.rsplit(".", 1)[1]
    env = dict(os.environ, RAYTRACER_EXAMPLE_SIZE="80x45",
               PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", f"raytracer_tpu_torch.examples.{name}",
         "--device", "cpu"],
        capture_output=True, timeout=300, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    got, maxval = read_p3(out.stdout)
    assert got.shape == (45, 80, 3) and maxval == 255 and got.max() > 0

    monkeypatch.setenv("RAYTRACER_EXAMPLE_SIZE", "80x45")
    cam = jax_camera(example_camera(example.LOOK_AT))
    want = jax_render(jax_build_scene(to_jax_specs(example.items())), cam,
                      quantize=True)
    diff = np.abs(got - want.astype(np.int32)).max(-1)
    assert (diff > 1).mean() <= 0.005, int((diff > 1).sum())
    assert want.std() > 5
