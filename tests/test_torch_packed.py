"""Live-ray compaction of deep levels (``core/render._packed_shade_level``
and its use in ``color_at``) against the JAX package's, on the CPU.

The scene: a 2x2 area light in deterministic jitter (0.5,), so both
packages draw the same jitter at any width, over a reflective plane and a
glass sphere (the n1/n2 walk); the port-only checks add a 96-triangle
mesh, so K1's plain version sees packed widths that are not multiples of
its 256-ray subtile. The JAX side runs op by op under
``jax.disable_jit()``, which also makes its width chain (a ``lax.cond``)
run the chosen branch op by op; port against JAX holds to rtol 1e-5, atol
1e-6, in both of the JAX package's modes (``thread_perm``: its outputs in
live-first order, put back in row order through the order it returns).
The port's packed level against its own full-width level is bit-equal
once zero-weight spawns are parked, as ``color_at`` parks them: each
ray's result does not depend on its batch."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import render as JR
from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.camera import Camera, ray_grid
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.parallel import partition_scene, render_loss_and_grad
from raytracer_tpu_torch.scene import build_scene, specs as S
from torch_port_helpers import same_tables, unit_rays

RTOL, ATOL = 1e-5, 1e-6
N_RAYS = 4096     # the packed widths are color_at's at its smallest tile


def items(mesh=True):
    rng = np.random.default_rng(4)
    p = (rng.uniform(-0.4, 0.4, (96, 1, 3))
         + rng.normal(0.0, 0.15, (96, 3, 3)) + np.array([1.2, 0.6, -0.5]))
    return [
        S.AreaLight(corner=(-3.0, 6.0, -4.0), uvec=(2.0, 0.0, 0.0), usteps=2,
                    vvec=(0.0, 0.0, 2.0), vsteps=2),
        S.Plane(material=S.Material(specular=0.0, reflective=0.4)),
        S.Sphere(transform=tf.translation(-0.5, 1.0, 0.5),
                 material=S.Material(color=(0.1, 0.2, 0.3), diffuse=0.2,
                                     transparency=0.9, refractive_index=1.5)),
    ] + [S.Mesh(p=p.astype(np.float32),
                material=S.Material(color=(0.9, 0.4, 0.1), reflective=0.3))
         ][:int(mesh)]


@pytest.fixture(scope="module")
def scenes_():
    """(JAX scene, port scene) without the mesh: op by op, the JAX mesh
    scan compiles for tens of seconds at every width."""
    return same_tables(items(mesh=False), jitter=(0.5,), recursion_limit=3)


def mesh_scene(random_draws=False):
    return build_scene(items(), jitter=None if random_draws else (0.5,),
                       recursion_limit=3, device="cpu")


def level_inputs(n_live, seed=0, n=N_RAYS):
    """``n`` level rays, ``n_live`` of them live (weights in (0.2, 1]) at
    random rows, the rest parked with zero weight, as color_at leaves
    them."""
    rng = np.random.default_rng(seed)
    o, d = unit_rays(rng, n, center=(0.0, 1.0, -5.0), spread=1.5)
    w = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    dead = np.ones(n, bool)
    dead[rng.choice(n, n_live, replace=False)] = False
    w[dead] = 0.0
    o[dead] = R.PARK_ORIGIN
    d[dead] = R.PARK_DIR
    return o, d, w


def flat(out):
    colored, refl, refr, *order = out
    return [colored, *refl, *refr, *order]


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_level_vs_jax(js, ps, n_live, width, jax_thread_perm):
    """The port's packed level against the JAX package's on the same level
    inputs, ``n_live`` of N_RAYS rays live (which picks ``width``); the
    JAX package's in its ``thread_perm`` mode put back in row order."""
    o, d, w = level_inputs(n_live)
    assert R._packed_width(N_RAYS, n_live) == width
    got = flat(R._packed_shade_level(
        ps, *map(torch.as_tensor, (o, d, w)), None, width=width))
    with jax.disable_jit():
        want = [as_np(x) for x in flat(JR._packed_shade_level(
            js, *map(jnp.asarray, (o, d, w)), None,
            thread_perm=jax_thread_perm))]
    if jax_thread_perm:
        back = np.argsort(want.pop())
        want = [x[back] for x in want]
    assert len(got) == len(want) == 7
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(as_np(a), as_np(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"output {k}")
    assert float(np.abs(as_np(got[0])).sum()) > 0.0


# Two of the four widths, the two that color_at's levels take below (a JAX
# op compiles once per shape, and these share color_at's shapes);
# tests/test_torch_packed_levels.py takes R/16 and R/2.
@pytest.mark.parametrize("jax_thread_perm", [False, True])
@pytest.mark.parametrize("n_live,width", [(800, N_RAYS // 4),
                                          (3600, N_RAYS)])
def test_packed_level_matches_jax(scenes_, n_live, width, jax_thread_perm):
    check_level_vs_jax(*scenes_, n_live, width, jax_thread_perm)


# a 96x54 tile (glass_mesh(4) in chip_smoke's phase 4): its packed widths,
# 324 to 5184 rays, are not whole 256-ray subtiles of K1
N_ODD = 96 * 54


@pytest.mark.parametrize("random_draws", [False, True])
@pytest.mark.parametrize("n_live", [300, 1200, 2400, 5000])
def test_packed_level_equals_full_width(n_live, random_draws):
    """The packed level against the full-width level bit for bit, the
    mesh's K1 queries included (K1's plain version pads each width to
    whole subtiles).

    In the deterministic jitter sequence, against ``shade_level`` of the
    whole level: the rows past ``width`` are parked with zero weight,
    where the full-width level shades the dead rays' zero-weight spawns:
    equal once parked. With random area-light draws, the k-th live ray
    takes draw row k: against ``shade_level`` of the level's first
    ``width`` rows in live-first order (the live rays in row order) with
    the first ``width`` rows of the draws, each output row in its ray's
    row, and every other row unshaded (zero, parked)."""
    ps = mesh_scene(random_draws)
    o, d, w = map(torch.as_tensor, level_inputs(n_live, seed=1, n=N_ODD))
    width = R._packed_width(N_ODD, n_live)
    assert width % 256 or n_live == 5000

    def parked(out):
        colored, *spawns = out[:3]
        return [colored] + [x for so, sd, sw in spawns for x in (
            *R.park_rays(so, sd, (sw > 0.0).any(-1)), sw)]

    if not random_draws:
        got = parked(R._packed_shade_level(ps, o, d, w, width=width))
        for k, (a, b) in enumerate(zip(got, parked(R.shade_level(
                ps, o, d, w)))):
            assert torch.equal(a, b), f"output {k}"
    else:
        jitter = R.draw_jitter(ps, N_ODD, torch.Generator().manual_seed(3))
        live = (w > 0).any(-1)
        sel = torch.argsort(~live, stable=True)[:width]
        assert torch.equal(sel[:n_live], live.nonzero()[:, 0])
        rest = torch.ones(N_ODD, dtype=torch.bool)
        rest[sel] = False
        got = flat(R._packed_shade_level(ps, o, d, w, jitter, width=width))
        want = flat(R.shade_level(ps, o[sel], d[sel], w[sel],
                                  tuple(j[:width] for j in jitter)))
        for k, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a[sel], b), f"output {k}"
            unshaded = torch.tensor(R._UNSHADED[3 * k:3 * k + 3])
            assert torch.equal(a[rest], unshaded.expand(int(rest.sum()), 3))
    assert float(got[1 + 2].abs().sum()) > 0.0     # live reflection weight


def frame_rays(device="cpu"):
    """64x64 = 4096 rays in render's 16x16-block order: the smallest tile
    that packs."""
    cam = Camera(64, 64, math.pi / 3).with_transform(
        tf.view_transform((0.0, 1.5, -5.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)))
    o, d = ray_grid(cam, device=device)
    order = torch.tensor(R._block_order(64, 64, 16))
    return o[order].contiguous(), d[order].contiguous()


def test_color_at_packs_and_matches_jax(scenes_, monkeypatch):
    js, ps = scenes_
    o, d = frame_rays()
    assert R.packs(ps.static, o.shape[0])
    assert not R.packs(ps.static, o.shape[0] - 16)   # under 4096 rays
    widths = []
    real = R.shade_step

    def spy(*a, **kw):
        widths.append(kw["width"])
        return real(*a, **kw)

    monkeypatch.setattr(R, "shade_step", spy)
    with torch.no_grad():
        got = R.color_at(ps, o, d).numpy()
    with jax.disable_jit():
        want = np.asarray(JR.color_at(js, jnp.asarray(o.numpy()),
                                      jnp.asarray(d.numpy())))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # level 0 whole, levels 1 to 3 at 4096, 1024 and 1024 rows (2489, 646,
    # 509 live)
    assert widths == [None, 4096, 1024, 1024], widths
    assert got.std() > 0.05


def test_remat_packed_matches_no_remat():
    """color_at on a packing scene with seeded jitter: remat on and off give
    the same loss and gradients and leave the generator in one state (the
    packed level's recompute takes the width it was given, and redraws the
    same jitter)."""
    sc = build_scene(items(), recursion_limit=3, device="cpu")
    o, d = frame_rays()
    assert R.packs(sc.static, o.shape[0])
    params, recombine = partition_scene(sc)
    target = torch.full_like(o, 0.25)
    out = []
    for remat in (False, True):
        g = torch.Generator().manual_seed(11)
        loss, grads = render_loss_and_grad(params, recombine, o, d, target, g,
                                           remat=remat)
        out.append((loss, grads, g.get_state()))
    (l0, g0, s0), (l1, g1, s1) = out
    np.testing.assert_allclose(float(l1), float(l0), rtol=RTOL)
    assert set(g0) == set(g1)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=RTOL,
                                   atol=1e-8, err_msg=k)
    assert torch.equal(s0, s1)
    assert float(g0["alight_intensity"].abs().sum()) > 0.0
