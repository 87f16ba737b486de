"""The plain reference of CSG solids under area lights: tracer.py's
quadrics, shading and camera, with the CSG filter of csg.rs and the soft
shadows and sampled lighting of lights.rs and materials.rs.

* CSG (csg.rs:26-49, 51-72, 74-85, 117-123). A node's hits are its left
  child's hits, then its right child's, sorted by t (a stable sort, so a
  tie keeps the left child's hit first), negative ones included. The
  node walks them in that order, keeping whether the ray is inside its
  left and inside its right child, and keeps the hits that
  ``intersection_allowed`` allows; after each hit it flips the state of
  the side the hit came from. A child that is itself a node gives its
  filtered hits: nested nodes filter bottom-up. The world's hit is the
  smallest filtered t > 0, and a shadow ray is tested against the same
  filtered hits (world.rs:101-111).
* Area lights (lights.rs:105-134, materials.rs:136-175). A light of
  usteps x vsteps cells has S samples, one a cell: the cell's corner plus
  a jitter in [0, 1) along each of its two edges. The intensity at a point
  is the share of S samples, jittered, whose shadow ray is not blocked;
  the lighting is the ambient term once plus the mean over S fresh
  jittered samples of the diffuse and specular terms with the sample as
  the light's position, times that intensity.
* Jitter. ``Scene(..., jitter=None, seed=n)`` draws every jitter from a
  ``torch.Generator`` of its own seeded with n: per block of rays and per
  area light one ``torch.rand((rays, S, 4))`` (the intensity pass's u and
  v, then the lighting pass's). ``jitter=(c,)`` or ``(cu, cv)`` puts
  every u draw at ``cu`` and every v draw at ``cv``: the constant
  sequence of lights.rs's test hook (lights.rs:77-81).

Departures from the Rust semantics, each also the measured program's:
the random stream is torch's and not ``rand::thread_rng``'s (the same
uniform distribution); the scene has no point light and no material that
reflects or refracts (both are refused), so a frame is one level of
primary rays and a ray that hits nothing is black; computed in ``dtype``
(float32 for the check, as the Rust code's f32; a lower one for the
control), in blocks of rays, with TF32 off. It imports nothing but torch,
numpy and tracer.py.

The scene description is tracer.py's (``shapes``, ``materials``,
``camera``) with ``lights`` empty, and two keys more:

    "csg": [tree, ...]    a tree is [op, left, right], op one of "union",
                          "intersect", "difference", a child a tree or the
                          index of a shape in "shapes";
    "area_lights": [{"corner", "uvec", "usteps", "vvec", "vsteps",
                     "intensity"}]     (uvec, vvec: the whole edges)

A shape that no tree holds is an object of the world on its own.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import tracer
from rtbench.reference.tracer import EPSILON, INF, _dot, _normalize

RAY_BLOCK = 8192       # primary rays a block (x S shadow rays each)


class Scene(tracer.Scene):
    """tracer.Scene's tables, the CSG trees and the area lights.
    ``jitter``: None for random draws from a generator seeded with
    ``seed``, or (c,) or (cu, cv) for constant draws."""

    def __init__(self, desc, *, device="cpu", dtype=torch.float32,
                 jitter=None, seed=0):
        if desc.get("lights"):
            raise NotImplementedError("point lights")
        super().__init__(desc, device=device, dtype=dtype)
        mats = [tracer.material(**m) for m in desc["materials"]]
        if any(m["reflective"] or m["transparency"] for m in mats):
            raise NotImplementedError("reflective or transparent materials")
        if any(m["pattern"] is not None for m in mats):
            raise NotImplementedError("patterns")
        self.trees = list(desc.get("csg", []))
        held = set()

        def leaves(node):
            if isinstance(node, int):
                held.add(node)
            else:
                leaves(node[1])
                leaves(node[2])

        for tree in self.trees:
            leaves(tree)
        self.free = [q for q in range(self.n_quad) if q not in held]

        def ten(x):
            return torch.as_tensor(np.asarray(x, np.float64)).to(
                device=self.device, dtype=dtype)

        self.lights = []
        for lt in desc["area_lights"]:
            us, vs = int(lt["usteps"]), int(lt["vsteps"])
            self.lights.append(dict(
                corner=ten(lt["corner"]), uvec=ten(lt["uvec"]) / us,
                vvec=ten(lt["vvec"]) / vs, intensity=ten(lt["intensity"]),
                uu=ten(np.repeat(np.arange(us), vs)),
                vv=ten(np.tile(np.arange(vs), us)), samples=us * vs))
        self.jitter = None if jitter is None else (jitter[0], jitter[-1])
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def draws(self, rays, samples):
        """(ju1, jv1, ju2, jv2), each [rays, samples]: the intensity
        pass's u and v jitter, then the lighting pass's."""
        if self.jitter is not None:
            cu, cv = (torch.full((rays, samples), c, dtype=self.dtype,
                                 device=self.device) for c in self.jitter)
            return cu, cv, cu, cv
        r = torch.rand((rays, samples, 4), generator=self.generator,
                       device=self.device).to(self.dtype)
        return r.unbind(-1)


def _allowed(op, lhit, in_l, in_r):
    """csg.rs:117-123."""
    if op == "union":
        return (lhit & ~in_r) | (~lhit & ~in_l)
    if op == "intersect":
        return (lhit & in_r) | (~lhit & in_l)
    if op == "difference":
        return (lhit & ~in_r) | (~lhit & in_l)
    raise ValueError(f"no CSG operation {op!r}")


def csg_hits(node, ts, objs):
    """The hits of ``node`` (a tree or a shape's index) for rays whose
    quadric intersections are ``ts`` [N, C] (column j of shape
    ``objs[j]``): (t [N, K], object [N, K]), a node's in order of t, the
    hits it does not allow at +inf."""
    if isinstance(node, int):
        cols = [j for j, q in enumerate(objs) if q == node]
        t = ts[:, cols]
        return t, torch.full(t.shape, node, dtype=torch.long,
                             device=ts.device)
    op, left, right = node
    lt, lo = csg_hits(left, ts, objs)
    rt, ro = csg_hits(right, ts, objs)
    t, obj = torch.cat([lt, rt], 1), torch.cat([lo, ro], 1)
    side = torch.cat([torch.ones_like(lo, dtype=torch.bool),
                      torch.zeros_like(ro, dtype=torch.bool)], 1)
    order = torch.argsort(t, dim=1, stable=True)
    t, obj, side = (x.gather(1, order) for x in (t, obj, side))
    in_l = torch.zeros(t.shape[0], dtype=torch.bool, device=t.device)
    in_r = torch.zeros_like(in_l)
    keep = []
    for j in range(t.shape[1]):
        real, lhit = torch.isfinite(t[:, j]), side[:, j]
        keep.append(real & _allowed(op, lhit, in_l, in_r))
        in_l = in_l ^ (real & lhit)
        in_r = in_r ^ (real & ~lhit)
    return torch.where(torch.stack(keep, 1), t, INF), obj


def world_hits(sc, o, d):
    """Every filtered intersection of the world along rays o, d [N, 3]:
    (t [N, K], object [N, K]), the trees' hits after their filters, then
    the free shapes' (unsorted; +inf where there is none)."""
    ts, objs = tracer.quadric_ts(sc, o, d)
    parts = [csg_hits(tree, ts, objs) for tree in sc.trees]
    parts += [csg_hits(q, ts, objs) for q in sc.free]
    if not parts:
        return (o.new_full((o.shape[0], 1), INF),
                torch.zeros((o.shape[0], 1), dtype=torch.long,
                            device=o.device))
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1))


def nearest(sc, o, d):
    """The smallest filtered t > 0 along each ray and its object: (t [N]
    (+inf: none), object [N])."""
    t, obj = world_hits(sc, o, d)
    t = torch.where(t > 0, t, INF)
    t_min, k = t.min(1)
    return t_min, obj.gather(1, k[:, None])[:, 0]


def blocked(sc, over, pos):
    """world.rs:101-111 for every sample: over [R, 3], sample positions
    pos [R, S, 3] -> [R, S] bool."""
    r, s = pos.shape[:2]
    v = pos - over[:, None]
    dist = torch.sqrt(_dot(v, v))
    direction = (v / dist[..., None]).reshape(-1, 3)
    t, obj = nearest(sc, over[:, None].expand(r, s, 3).reshape(-1, 3),
                     direction)
    flag = sc.obj_shadow[obj]
    return (torch.isfinite(t) & (t < dist.reshape(-1)) & flag).reshape(r, s)


def _phong_sum(sc, mi, eff, lt, over, eyev, normalv, pos):
    """materials.rs's diffuse + specular terms summed over the samples
    ``pos`` [R, S, 3] as the light's position: [R, 3]."""
    p = sc.params
    lightv = _normalize(pos - over[:, None])
    ldn = _dot(lightv, normalv[:, None])
    lit = ldn >= 0
    diffuse = (eff * p["mat.diffuse"][mi][:, None])[:, None] * ldn[..., None]
    reflectv = -lightv + 2.0 * ldn[..., None] * normalv[:, None]
    rde = _dot(reflectv, eyev[:, None])
    factor = torch.pow(rde.clamp_min(0), p["mat.shininess"][mi][:, None])
    specular = lt["intensity"] * (p["mat.specular"][mi][:, None]
                                  * factor)[..., None]
    ds = torch.where(lit[..., None], diffuse, 0.0) + torch.where(
        (lit & (rde > 0))[..., None], specular, 0.0)
    return ds.sum(1)


def shade(sc, o, d):
    """The colours [R, 3] of primary rays o, d: the nearest filtered hit,
    its normal, and each area light's ambient plus its sampled lighting
    times its unblocked share."""
    p = sc.params
    t, obj = nearest(sc, o, d)
    has = torch.isfinite(t)
    t = torch.where(has, t, torch.ones_like(t))
    point = o + t[:, None] * d
    eyev = -d
    normalv = tracer._quadric_normal(sc, obj, point)
    flip = _dot(normalv, eyev) < 0
    normalv = torch.where(flip[:, None], -normalv, normalv)
    over = point + EPSILON * normalv
    mi = sc.obj_mat[obj]
    color = p["mat.color"][mi]
    surface = torch.zeros_like(color)
    for lt in sc.lights:
        s = lt["samples"]
        ju1, jv1, ju2, jv2 = sc.draws(o.shape[0], s)

        def positions(ju, jv, lt=lt):
            return (lt["corner"] + (lt["uu"] + ju)[..., None] * lt["uvec"]
                    + (lt["vv"] + jv)[..., None] * lt["vvec"])

        share = (~blocked(sc, over, positions(ju1, jv1))).to(
            sc.dtype).sum(1) / s
        eff = color * lt["intensity"]
        ambient = eff * p["mat.ambient"][mi][:, None]
        ds = _phong_sum(sc, mi, eff, lt, over, eyev, normalv,
                        positions(ju2, jv2))
        surface = surface + ambient + (ds / s) * share[:, None]
    return torch.where(has[:, None], surface, 0.0)


def render_u8(sc):
    """The scene's frame [vsize, hsize, 3] uint8 (numpy), in blocks of
    RAY_BLOCK rays, in row-major pixel order (the jitter drawn block by
    block in that order)."""
    cam = sc.desc["camera"]
    h, v = int(cam["hsize"]), int(cam["vsize"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        with torch.no_grad():
            for start in range(0, h * v, RAY_BLOCK):
                pix = torch.arange(start, min(start + RAY_BLOCK, h * v),
                                   device=sc.device)
                o, d = tracer.camera_rays(cam, device=sc.device,
                                          dtype=sc.dtype, pixels=pix)
                out.append(tracer.quantize_u8(shade(sc, o, d)).cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.cat(out).numpy().reshape(v, h, 3)
