"""Inputs for the mesh kernel K1's checks, made with numpy from fixed seeds.

Each ``*_case`` returns a dict of f32 arrays: the triangles (p1, e1, e2,
``[Nt, 3]``, for ``ops.mesh_cuda.pack_tri_planes_np``), the rays (o, d,
``[R, 3]``) and, where the case caps the search, ``t_init`` ``[R]``.
``chip_smoke.py`` and ``tests/test_torch_*.py`` hold K1 against its plain
version and the JAX kernel on them.
"""

from __future__ import annotations

import numpy as np

SUPER = 8192      # triangles per supergroup (CHUNK * SG)
TIE_INDEX = 100   # the index that must win every hit of tie_case()


def _unit(d):
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _f32(x):
    return np.ascontiguousarray(x, np.float32)


def stream_case(r, seed=9):
    """20,000 depth-sorted triangles (3 supergroups) and r rays from above
    z = 10 heading +z, a third of them uncapped, the rest capped in [1, 30].
    """
    rng = np.random.default_rng(seed)
    nt = 20000
    c = rng.uniform(-3, 3, (nt, 3))
    c[:, 2] = np.sort(rng.uniform(0, 30, nt))
    p1 = c + rng.normal(0, 0.1, (nt, 3))
    e1, e2 = rng.normal(0, 0.2, (nt, 3)), rng.normal(0, 0.2, (nt, 3))
    o = rng.uniform(-2, 2, (r, 3)) + np.array([0, 0, 10.0])
    d = _unit(rng.normal(0, 0.3, (r, 3)) + np.array([0, 0, 1.0]))
    cap = rng.uniform(1, 30, r)
    cap[::3] = np.inf
    return dict(p1=_f32(p1), e1=_f32(e1), e2=_f32(e2), o=_f32(o), d=_f32(d),
                t_init=_f32(cap))


def tie_case():
    """One triangle at three indices, TIE_INDEX, TIE_INDEX + SUPER and
    TIE_INDEX + 2*SUPER + 3*1024 + 7 (three supergroups, two slices), in
    front of 256 rays heading +z, with every other triangle far behind it:
    each ray hits all three copies at the same t. Supergroup 1 also holds
    triangles off the rays' path at z = -2, so its box is entered first.
    The lowest index, TIE_INDEX, must win every hit."""
    rng = np.random.default_rng(11)
    nt = 3 * SUPER
    p1 = rng.uniform(-3, 3, (nt, 3))
    p1[:, 2] = rng.uniform(50, 60, nt)
    e1, e2 = rng.normal(0, 0.5, (nt, 3)), rng.normal(0, 0.5, (nt, 3))
    for j in (TIE_INDEX, TIE_INDEX + SUPER, TIE_INDEX + 2 * SUPER + 3 * 1024 + 7):
        p1[j], e1[j], e2[j] = (-1.0, -1.0, 0.0), (2.5, 0, 0), (0, 2.5, 0)
    side = slice(SUPER + 2000, SUPER + 2050)
    p1[side] = rng.normal(0, 0.1, (50, 3)) + np.array([20.0, 0, -2.0])
    o = np.concatenate([rng.uniform(-0.2, 0.2, (256, 2)),
                        np.full((256, 1), -5.0)], 1)
    d = np.tile([0.0, 0.0, 1.0], (256, 1))
    return dict(p1=_f32(p1), e1=_f32(e1), e2=_f32(e2), o=_f32(o), d=_f32(d))


def padding_case(through):
    """8192 + 1664 triangles: the last supergroup holds 1664 real ones and
    6 chunks of padding only, as glass_mesh's does. 256 rays from z = -8,
    aimed at the soup (``through``) or away from it."""
    rng = np.random.default_rng(12)
    nt = SUPER + 1664
    p1 = rng.uniform(-3, 3, (nt, 3))
    e1, e2 = rng.normal(0, 0.5, (nt, 3)), rng.normal(0, 0.5, (nt, 3))
    o = rng.uniform(-1, 1, (256, 3)) + np.array([0, 0, -8.0])
    aim = np.array([0, 0, 3.0 if through else -6.0])
    d = _unit(rng.normal(0, 1, (256, 3)) + aim)
    return dict(p1=_f32(p1), e1=_f32(e1), e2=_f32(e2), o=_f32(o), d=_f32(d))


def inside_boxes_case(r=2048):
    """Shadow rays as the renderer casts them: each starts on a triangle of
    the 20,000-triangle stream (1e-3 off its surface, so inside chunk
    boxes, where the slab tmin is < 0), heads in a random direction, and
    is capped in [0.5, 10]. For the any-hit mode."""
    s = stream_case(16)
    rng = np.random.default_rng(13)
    j = rng.integers(0, s["p1"].shape[0], r)
    a, b = rng.uniform(0, 0.5, (2, r, 1))
    n = _unit(np.cross(s["e1"][j], s["e2"][j]))
    o = s["p1"][j] + a * s["e1"][j] + b * s["e2"][j] + 1e-3 * n
    d = _unit(rng.normal(0, 1, (r, 3)))
    return dict(p1=s["p1"], e1=s["e1"], e2=s["e2"], o=_f32(o), d=_f32(d),
                t_init=_f32(rng.uniform(0.5, 10, r)))


PREPASS_SUPERS = (1, 7, 130, 300)   # the pre-pass cases' supergroup counts


def prepass_case(n_super, seed=21):
    """Supergroup boxes and 512 rays for the pre-pass K1b alone, as
    ``bb_super`` [6, n_super] (rows lo x, y, z, hi x, y, z) beside o, d
    and a cap ``t_init`` [512]. The first subtile's rays start at z = -5
    and head +z: box n_super // 3 holds many of their origins (entry 0,
    clamped from below), and ray 0 starts on its high x face heading -x
    (a slab entry of -0); boxes 1 and n_super - 1 repeat boxes 0 and
    n_super // 2 (tied entries). The second subtile's rays head away
    from every box (no live supergroup)."""
    rng = np.random.default_rng(seed + n_super)
    c = np.stack([rng.uniform(-4, 4, n_super), rng.uniform(-4, 4, n_super),
                  rng.uniform(2, 30, n_super)], 1)
    half = rng.uniform(0.2, 1.5, (n_super, 3))
    lo, hi = c - half, c + half
    inside = n_super // 3
    lo[inside], hi[inside] = (-1.0, -1.0, -6.0), (1.0, 1.0, -4.0)
    if n_super >= 3:
        lo[1], hi[1] = lo[0], hi[0]
        lo[-1], hi[-1] = lo[n_super // 2], hi[n_super // 2]
    o = np.concatenate([
        np.concatenate([rng.uniform(-1.5, 1.5, (256, 2)),
                        np.full((256, 1), -5.0)], 1),
        rng.uniform(-1, 1, (256, 3)) + np.array([0, 0, -10.0])])
    d = np.concatenate([_unit(rng.normal(0, 0.3, (256, 3)) + [0, 0, 1.0]),
                        _unit(rng.normal(0, 0.3, (256, 3)) + [0, 0, -1.0])])
    o[0] = (1.0, 0.0, -5.0)
    d[0] = _unit(np.array([-1.0, 0.2, 0.3]))
    cap = rng.uniform(0, 30, 512)
    cap[::5] = np.inf
    return dict(bb_super=_f32(np.concatenate([lo.T, hi.T])), o=_f32(o),
                d=_f32(d), t_init=_f32(cap))
