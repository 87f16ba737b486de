"""Batched ray-primitive intersection.

Counterpart of ``raytracer_tpu/core/intersect.py``. A whole ray batch
meets each primitive FAMILY at once:

* quadric families (sphere/plane/cube/cylinder/cone) move the batch into
  every primitive's object space, then run the family's closed-form solve
  elementwise. The 3x3 products are written out as chains of fused
  multiply-adds (:func:`mat3_apply`, no matmul), so they round as the
  JAX package's einsums round on the CPU, the same on every device, and
  no TF32 path can touch them;
* CSG triangles get dense columns (the CSG filter needs every hit), and
  the CSG filter (:mod:`raytracer_tpu_torch.core.csg`) runs on the static
  columns;
* free triangles are world-space tables packed for the mesh kernel: every
  free-mesh query (nearest, any-hit shadow, nearest-behind) is one
  :func:`raytracer_tpu_torch.ops.mesh_cuda.mesh_nearest` call — the CUDA
  kernel on a CUDA tensor, its plain version on a CPU tensor.

The result is a per-ray candidate table ``(t, gid, u, v)`` with +inf for
misses. Every per-primitive lookup the JAX package routes through
``table_gather`` goes through :func:`table_gather` here: on the card the
kernels of ``csrc/table_gather.cu`` (a copy forward, a deterministic
reduction backward), on the CPU plain indexing with an ``index_add_``
backward. ``select_col`` is ``torch.gather``: it reads one column per row,
so its backward has no duplicate index to walk. argmin ties resolve to
the first index, as ``first_hit`` assumes.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.constants import EPSILON
from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.core.csg import apply_csg
from raytracer_tpu_torch.ops import gather_cuda as GA
from raytracer_tpu_torch.ops import mesh_cuda as MC

INF = float("inf")


def mat3_apply(m, x):
    """m [..., 3, 3] applied to x [..., 3] (broadcasting), rounded as
    XLA's f32 dot rounds the JAX package's ``einsum``s on the CPU: the
    column products accumulated in order, each step one fused
    multiply-add, fma(x2, m[:, 2], fma(x1, m[:, 1], x0 m[:, 0])).
    Summing rounded products instead puts many outputs one ulp off
    XLA's, which a grazing bounce can grow into a visible step (fuzz seed
    19).

    On a CUDA tensor a step is torch's ``addcmul``, which the card runs
    as one f32 fused multiply-add (chip_smoke phase 9 holds it bit for bit
    against the f64 steps). Elsewhere a step is an ``addcmul`` in f64,
    where the product of two f32 values is exact, rounded once to f32 (a
    double rounding would need the f64 sum to land on an f32 midpoint)."""
    acc = x[..., 0:1] * m[..., :, 0]
    if x.is_cuda:
        for j in (1, 2):
            acc = torch.addcmul(acc, x[..., j:j + 1], m[..., :, j])
        return acc
    xd = x.double()
    for j in (1, 2):
        acc = torch.addcmul(acc, xd[..., j:j + 1], m[..., :, j]).float()
    return acc


def dot3(a, b):
    """Sum over the last axis of 3, in a fixed order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def select_col(x, idx):
    """x[r, idx[r]] along the last axis."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def table_gather(table, idx):
    """``table[idx]`` for a table [G, *rest] and integer indices of any
    shape -> [*idx, *rest]: the counterpart of the JAX package's
    ``intersect.table_gather``. Its gradient, where the table requires
    one, is the sum of the output's gradient rows by index. On a CUDA
    tensor the kernels of ``csrc/table_gather.cu`` (the backward
    deterministic: the same inputs give the same bits, eagerly and in a
    graph replay); on a CPU tensor plain indexing with an ``index_add_``
    backward (:mod:`raytracer_tpu_torch.ops.gather_cuda`)."""
    return GA.table_gather(table, idx)


def transform_row(scene: T.Scene, gid):
    """Row of ``scene.inv_tf``/``scene.normal_mat`` for each gid.

    Non-triangle gids map to themselves; triangle gids map through
    ``tri_tf_id`` to their SOURCE row (types.Scene layout).
    """
    st = scene.static
    g_nt = sum(st.counts[:5])
    if st.counts[5] == 0:
        return gid
    tri = (gid - g_nt).clamp(0, scene.tri_tf_id.shape[0] - 1)
    return torch.where(gid >= g_nt, g_nt + scene.tri_tf_id[tri], gid)


def _local_rays(inv_tf, origins, directions):
    """Transform ray batch into each primitive's object space.

    inv_tf [N,4,4]; origins/directions [R,3] -> ([R,N,3], [R,N,3]).
    Points use the translation column, vectors don't (rays.rs:19-24).
    """
    rot = inv_tf[:, :3, :3]                      # [N,3,3]
    trans = inv_tf[:, :3, 3]                     # [N,3]
    o = mat3_apply(rot, origins[:, None, :]) + trans[None]
    d = mat3_apply(rot, directions[:, None, :])
    return o, d


def _safe_sqrt(x, ok):
    return torch.sqrt(torch.clamp_min(torch.where(ok, x, 1.0), 1e-10))


def _sphere_ts(o, d):
    """sphere.rs:64-80; unit sphere at origin, 2 candidate ts."""
    a = dot3(d, d)
    b = 2.0 * dot3(d, o)
    c = dot3(o, o) - 1.0
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = _safe_sqrt(disc, ok)
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    return torch.stack([torch.where(ok, t1, INF), torch.where(ok, t2, INF)], -1)


def _plane_ts(o, d):
    """plane.rs:66-73; xz-plane, parallel guard at EPSILON."""
    ok = d[..., 1].abs() >= EPSILON
    t = -o[..., 1] / torch.where(ok, d[..., 1], 1.0)
    return torch.where(ok, t, INF)[..., None]


def check_axis(origin, direction, lo, hi):
    """cube.rs:67-85 slab helper."""
    tmin_num = lo - origin
    tmax_num = hi - origin
    ok = direction.abs() >= EPSILON
    safe_d = torch.where(ok, direction, 1.0)
    pinf = torch.full_like(tmin_num, INF)
    tmin = torch.where(ok, tmin_num / safe_d,
                       torch.where(tmin_num >= 0.0, pinf, -pinf))
    tmax = torch.where(ok, tmax_num / safe_d,
                       torch.where(tmax_num >= 0.0, pinf, -pinf))
    swap = tmin > tmax
    return torch.where(swap, tmax, tmin), torch.where(swap, tmin, tmax)


def _cube_ts(o, d):
    """cube.rs:87-114; both slab ts (entry+exit), miss when tmin > tmax."""
    xtmin, xtmax = check_axis(o[..., 0], d[..., 0], -1.0, 1.0)
    ytmin, ytmax = check_axis(o[..., 1], d[..., 1], -1.0, 1.0)
    ztmin, ztmax = check_axis(o[..., 2], d[..., 2], -1.0, 1.0)
    tmin = torch.maximum(torch.maximum(xtmin, ytmin), ztmin)
    tmax = torch.minimum(torch.minimum(xtmax, ytmax), ztmax)
    ok = tmin <= tmax
    return torch.stack(
        [torch.where(ok, tmin, INF), torch.where(ok, tmax, INF)], -1)


def _cyl_ts(o, d, mn, mx, closed):
    """cylinder.rs:95-156: body hits y-clipped to (min, max), plus caps.

    4 candidate slots: body t0, body t1, lower cap, upper cap.
    """
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    a = dx * dx + dz * dz
    parallel = a.abs() < EPSILON
    b = 2.0 * (ox * dx + oz * dz)
    c = ox * ox + oz * oz - 1.0
    disc = b * b - 4.0 * a * c
    ok = (~parallel) & (disc >= 0.0)
    sq = _safe_sqrt(disc, ok)
    den = torch.where(parallel, 1.0, 2.0 * a)
    t0 = (-b - sq) / den
    t1 = (-b + sq) / den
    y0 = oy + t0 * dy
    y1 = oy + t1 * dy
    body0 = torch.where(ok & (mn < y0) & (y0 < mx), t0, INF)
    body1 = torch.where(ok & (mn < y1) & (y1 < mx), t1, INF)

    cap_ok = closed & (dy.abs() >= EPSILON)
    safe_dy = torch.where(dy.abs() >= EPSILON, dy, 1.0)
    tl = (mn - oy) / safe_dy
    tu = (mx - oy) / safe_dy

    def in_radius(t):
        x = ox + t * dx
        z = oz + t * dz
        # tolerance: rays through the exact cap edge land on either side
        # of 1.0 depending on rounding (cylinder.rs:150)
        return x * x + z * z <= 1.0 + 1e-5

    capl = torch.where(cap_ok & in_radius(tl), tl, INF)
    capu = torch.where(cap_ok & in_radius(tu), tu, INF)
    return torch.stack([body0, body1, capl, capu], -1)


def _cone_ts(o, d, mn, mx, closed):
    """cone.rs:123-165: double-napped cone, linear degenerate case, caps
    with radius |y|."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    a = dx * dx - dy * dy + dz * dz
    b = 2.0 * (ox * dx - oy * dy + oz * dz)
    c = ox * ox - oy * oy + oz * oz

    a_small = a.abs() < EPSILON
    b_small = b.abs() < EPSILON
    # linear branch: single t = -c / (2b) in slot0
    t_lin = -c / torch.where(b_small, 1.0, 2.0 * b)

    disc = b * b - 4.0 * a * c
    quad_ok = (~a_small) & (disc >= 0.0)
    sq = _safe_sqrt(disc, quad_ok)
    den = torch.where(a_small, 1.0, 2.0 * a)
    tq0 = (-b - sq) / den
    tq1 = (-b + sq) / den
    swap = tq0 > tq1  # a may be negative (cone.rs:150-153)
    t0 = torch.where(swap, tq1, tq0)
    t1 = torch.where(swap, tq0, tq1)
    y0 = oy + t0 * dy
    y1 = oy + t1 * dy
    body0 = torch.where(quad_ok & (mn < y0) & (y0 < mx), t0, INF)
    body1 = torch.where(quad_ok & (mn < y1) & (y1 < mx), t1, INF)
    # linear case: y-range is NOT checked (cone.rs:133-140)
    lin = a_small & ~b_small
    body0 = torch.where(lin, t_lin, body0)
    body1 = torch.where(lin, INF, body1)

    cap_ok = closed & (dy.abs() >= EPSILON)
    safe_dy = torch.where(dy.abs() >= EPSILON, dy, 1.0)
    tl = (mn - oy) / safe_dy
    tu = (mx - oy) / safe_dy

    def in_radius(t, y):
        x = ox + t * dx
        z = oz + t * dz
        return x * x + z * z <= y.abs() + 1e-5

    capl = torch.where(cap_ok & in_radius(tl, mn), tl, INF)
    capu = torch.where(cap_ok & in_radius(tu, mx), tu, INF)
    return torch.stack([body0, body1, capl, capu], -1)


def _tri_moller_trumbore(o, d, p1, e1, e2, det_eps=None):
    """triangle.rs:93-115 (world space), brute force.

    o,d [R,3]; p1,e1,e2 [Tc,3] -> (t, u, v) each [R,Tc]; misses = +inf t.
    ``det_eps`` [Tc]: per-triangle det threshold (types.Scene.tri_det_eps);
    None = plain EPSILON.
    """
    d_b = d[:, None, :]
    dce2 = torch.linalg.cross(d_b.expand(-1, e2.shape[0], -1),
                              e2[None].expand(d.shape[0], -1, -1))
    det = dot3(e1[None], dce2)
    thresh = EPSILON if det_eps is None else det_eps[None]
    ok = det.abs() >= thresh
    f = 1.0 / torch.where(ok, det, 1.0)
    p1o = o[:, None, :] - p1[None]
    u = f * dot3(p1o, dce2)
    ok &= (u >= 0.0) & (u <= 1.0)
    oce1 = torch.linalg.cross(p1o, e1[None].expand_as(p1o))
    v = f * dot3(d_b, oce1)
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = f * dot3(e2[None], oce1)
    return torch.where(ok, t, INF), u, v


_QUADRIC_SLOTS = (("sphere", 2), ("plane", 1), ("cube", 2),
                  ("cylinder", 4), ("cone", 4))


def static_columns(scene: T.Scene, kind: str):
    """Gid of each static candidate column, as (np.int32 [C], the same as
    an int32 tensor on the scene's device), made once per scene. ``kind``
    "hits": :func:`_static_hits`' table, the quadric families' slots then
    the CSG triangles (one zero column when there is neither). "shadow":
    :func:`shadow_blocked`'s, the quadric slots (one zero column when there
    are none), then the CSG triangles when the scene has a CSG tree."""
    def build():
        st = scene.static
        quad = np.concatenate(
            [np.repeat(np.arange(off, off + n, dtype=np.int32), slots)
             for off, n, slots in ((*st.family_range(name), slots)
                                   for name, slots in _QUADRIC_SLOTS)])
        tri_off = sum(st.counts[:5])
        tris = np.arange(tri_off, tri_off + st.n_csg_tris, dtype=np.int32)
        zero = np.zeros(1, np.int32)
        if kind == "hits":
            gids = np.concatenate([quad, tris])
            gids = gids if len(gids) else zero
        else:
            gids = quad if len(quad) else zero
            if st.csg_nodes and len(tris):
                gids = np.concatenate([gids, tris])
        return gids, torch.as_tensor(gids, device=scene.device)

    return scene.const(("columns", kind), build)


def _static_hits(scene: T.Scene, origins, directions):
    """Candidate intersections of the statically laid-out region: quadric
    families (fixed slots per primitive), then dense CSG triangles, with
    the CSG filter applied. Returns (ts, gid, u, v) each [R, Cs]."""
    st = scene.static
    ns, npl, ncu, ncy, nco, _ = st.counts
    off = st.offsets
    r = origins.shape[0]
    dev = origins.device

    ts_list = []

    def fam(name, n, fn, slots, extra=()):
        if n == 0:
            return
        base = off[T.FAMILIES.index(name)]
        o_l, d_l = _local_rays(scene.inv_tf[base : base + n],
                               origins, directions)
        ts = fn(o_l, d_l, *extra)                  # [R, n, slots]
        ts_list.append(ts.reshape(r, n * slots))

    fam("sphere", ns, _sphere_ts, 2)
    fam("plane", npl, _plane_ts, 1)
    fam("cube", ncu, _cube_ts, 2)
    fam("cylinder", ncy, _cyl_ts, 4,
        extra=(scene.cyl_min[None], scene.cyl_max[None], scene.cyl_closed[None]))
    fam("cone", nco, _cone_ts, 4,
        extra=(scene.cone_min[None], scene.cone_max[None], scene.cone_closed[None]))

    # CSG triangles: dense columns, after the quadric families
    ntc = st.n_csg_tris
    tri_uv = None
    if ntc:
        tts, tu, tv = _tri_moller_trumbore(
            origins, directions, scene.tri_p1[:ntc], scene.tri_e1[:ntc],
            scene.tri_e2[:ntc], det_eps=scene.tri_det_eps[:ntc])
        ts_list.append(tts)
        tri_uv = (tu, tv)

    if ts_list:
        ts = torch.cat(ts_list, -1)
    else:
        ts = torch.full((r, 1), INF, device=dev)
    static_gids, gid_cols = static_columns(scene, "hits")
    c_static = ts.shape[-1]
    gid = gid_cols[None, :].expand(r, -1)
    u = torch.zeros_like(ts)
    v = torch.zeros_like(ts)
    if tri_uv is not None:
        pad = torch.zeros((r, c_static - ntc), device=dev)
        u = torch.cat([pad, tri_uv[0]], -1)
        v = torch.cat([pad, tri_uv[1]], -1)

    if st.csg_nodes:
        ts = apply_csg(scene, ts, static_gids, c_static)
    return ts, gid, u, v


def _pad_rays(origins, directions, t_cap):
    """Pad a ray batch to a multiple of the kernel's subtile (padding rays
    start at 0 heading +z, uncapped; their results are dropped)."""
    r = origins.shape[0]
    pad = -r % MC.RT
    if not pad:
        return origins, directions, t_cap
    dev = origins.device
    origins = torch.cat([origins, torch.zeros((pad, 3), device=dev)])
    directions = torch.cat(
        [directions, T.small_const((0.0, 0.0, 1.0), dev).expand(pad, 3)])
    if t_cap is not None:
        t_cap = torch.cat([t_cap, torch.full((pad,), INF, device=dev)])
    return origins, directions, t_cap


def _mesh_query(scene, origins, directions, t_cap, any_hit, reverse):
    """One K1 query. When grad mode is on and the rays or the free
    triangles' rows require grad, a nearest query goes through
    :class:`~raytracer_tpu_torch.ops.mesh_cuda.MeshNearest` (the same
    forward, plus its backward); otherwise :func:`mesh_nearest` runs on
    detached inputs. An any-hit query returns verdicts and carries no
    gradient; the cap never does (as in the JAX package's scan path)."""
    r = origins.shape[0]
    st = scene.static
    o, d, cap = _pad_rays(origins, directions, t_cap)
    o, d = o.contiguous(), d.contiguous()
    cap = None if cap is None else cap.detach().contiguous()
    bb = (scene.mesh_bb_chunk, scene.mesh_bb_super)
    tris = tuple(x[st.n_csg_tris:]
                 for x in (scene.tri_p1, scene.tri_e1, scene.tri_e2))
    if (not any_hit and torch.is_grad_enabled()
            and any(x.requires_grad for x in (o, d) + tris)):
        t, idx, u, v = MC.MeshNearest.apply(o, d, *tris, scene.mesh_planes,
                                            bb, cap, reverse)
    else:
        with torch.no_grad():
            t, idx, u, v = MC.mesh_nearest(o, d, scene.mesh_planes, bb,
                                           t_init=cap, any_hit=any_hit,
                                           reverse=reverse)
    count = st.counts[5] - st.n_csg_tris
    gid = sum(st.counts[:5]) + st.n_csg_tris + torch.clamp_max(idx[:r],
                                                                 count - 1)
    return t[:r], gid, u[:r], v[:r]


def _tri_free_nearest(scene: T.Scene, origins, directions, t_cap=None,
                      any_hit=False):
    """Nearest positive hit over the free (non-CSG) triangles, through the
    mesh kernel. ``t_cap`` [R]: per-ray search cap (hits at t >= cap
    report +inf). ``any_hit``: existence only (t=0 for any hit below the
    cap). Returns (t [R], gid [R], u [R], v [R])."""
    return _mesh_query(scene, origins, directions, t_cap, any_hit, False)


def _tri_behind(scene: T.Scene, origins, directions):
    """The free-triangle entry with the LARGEST t < 0 (nearest behind the
    ray origin), for the n1/n2 container walk of transparent meshes.

    It is the nearest-hit query on the REVERSED ray: negating d negates the
    Moller-Trumbore determinant and leaves u, v and the numerators
    unchanged, so t reverses sign exactly. A hit at exactly t == 0 is
    excluded (the kernel takes t > 0 strictly), as in the JAX package's
    kernel path. Returns (t [R] (-inf = none), gid [R]).
    """
    t, gid, _, _ = _mesh_query(scene, origins, directions, None, False, True)
    return torch.where(torch.isfinite(t), -t, -INF), gid


def sorted_hits(scene: T.Scene, origins, directions, k: int = 12):
    """The reference's sorted Intersections list, truncated to ``k``.

    TEST ORACLE ONLY: the production path never sorts (see first_hit);
    this mirrors intersections.rs:66-73 for the book-value tests
    (``raytracer_tpu/core/intersect.py:912``). Returns (ts, gid, u, v),
    each [R, K], ascending by t (ties in column order), +inf padded.
    """
    ts, gid, u, v = candidate_hits(scene, origins, directions)
    # the behind column's "none" sentinel is -inf: a miss here
    ts = torch.where(torch.isneginf(ts), INF, ts)
    k = min(k, ts.shape[-1])
    order = torch.argsort(ts, dim=-1, stable=True)[:, :k]
    return tuple(torch.gather(x, -1, order) for x in (ts, gid, u, v))


def candidate_hits(scene: T.Scene, origins, directions):
    """All candidate intersections of a ray batch against the whole scene.

    Returns (ts [R,C], gid [R,C] i32, u [R,C], v [R,C]); misses have t=+inf.
    Column layout is static per scene: quadric families first, then one
    column holding the nearest POSITIVE free-triangle hit, and — when a
    free mesh material is transparent — one column holding the
    nearest-BEHIND free-triangle entry (largest t < 0, -inf when none).
    Two columns are exact for the n1/n2 container walk: the walk only
    reads the latest open container, and the only triangle entry it can
    select is the nearest behind the origin (see the JAX package's
    docstring for the proof).
    """
    st = scene.static
    ts, gid, u, v = _static_hits(scene, origins, directions)

    if st.counts[5] - st.n_csg_tris > 0:
        # Cap the mesh search at the nearest positive static hit: a
        # triangle at t >= that cap can never win first_hit and is never
        # consumed by the n1/n2 walk, and the cap seeds the kernel's gates.
        pos = (ts > 0.0) & torch.isfinite(ts)
        t_cap = torch.where(pos, ts, INF).amin(-1)
        ft, fg, fu, fv = _tri_free_nearest(scene, origins, directions,
                                           t_cap=t_cap)
        cols_t, cols_g, cols_u, cols_v = [ft], [fg], [fu], [fv]
        if st.mesh_transparent:
            bt, bg = _tri_behind(scene, origins, directions)
            cols_t.append(bt)
            cols_g.append(bg)
            cols_u.append(torch.zeros_like(bt))
            cols_v.append(torch.zeros_like(bt))
        ts = torch.cat([ts] + [c[:, None] for c in cols_t], -1)
        gid = torch.cat([gid] + [c[:, None].to(gid.dtype) for c in cols_g], -1)
        u = torch.cat([u] + [c[:, None] for c in cols_u], -1)
        v = torch.cat([v] + [c[:, None] for c in cols_v], -1)

    return ts, gid, u, v


def nearest_hit(scene: T.Scene, origins, directions):
    """The reference's hit() without a candidate table: masked argmin over
    the static region merged with the capped nearest mesh hit. Exact when
    no transparent material needs the n1/n2 container walk.

    Returns (has [R], t [R], gid [R], u [R], v [R]).
    """
    st = scene.static
    ts, gid, u, v = _static_hits(scene, origins, directions)
    pos = (ts > 0.0) & torch.isfinite(ts)
    masked = torch.where(pos, ts, INF)
    slot = masked.argmin(-1)
    t_s, g_s, u_s, v_s = (select_col(x, slot) for x in (masked, gid, u, v))

    if st.counts[5] - st.n_csg_tris > 0:
        t_m, g_m, u_m, v_m = _tri_free_nearest(
            scene, origins, directions, t_cap=t_s)
        better = t_m < t_s
        t_s = torch.where(better, t_m, t_s)
        g_s = torch.where(better, g_m.to(g_s.dtype), g_s)
        u_s = torch.where(better, u_m, u_s)
        v_s = torch.where(better, v_m, v_s)

    return torch.isfinite(t_s), t_s, g_s, u_s, v_s


def _shadow_static_ts(scene: T.Scene, over, direction):
    """Candidate ts of the quadric families for S shadow rays per
    receiver, with the receiver->object transform factored out of the
    sample axis.

    over [R,3], direction [R,S,3] -> ts [R,S,Cs], the columns of
    ``static_columns(scene, "shadow")``.
    """
    st = scene.static
    r, s = direction.shape[0], direction.shape[1]
    ts_list = []

    def fam(name, fn, slots, extra=()):
        fi = T.FAMILIES.index(name)
        off, n = st.offsets[fi], st.counts[fi]
        if n == 0:
            return
        inv = scene.inv_tf[off : off + n]
        rot = inv[:, :3, :3]
        trans = inv[:, :3, 3]
        o_l = mat3_apply(rot, over[:, None, :]) + trans[None]    # [R,N,3]
        d_l = mat3_apply(rot, direction[:, :, None, :])          # [R,S,N,3]
        ts = fn(o_l[:, None], d_l, *extra)                 # [R,S,N,slots]
        ts_list.append(ts.reshape(r, s, n * slots))

    fam("sphere", _sphere_ts, 2)
    fam("plane", _plane_ts, 1)
    fam("cube", _cube_ts, 2)
    fam("cylinder", _cyl_ts, 4,
        extra=(scene.cyl_min[None, None], scene.cyl_max[None, None],
               scene.cyl_closed[None, None]))
    fam("cone", _cone_ts, 4,
        extra=(scene.cone_min[None, None], scene.cone_max[None, None],
               scene.cone_closed[None, None]))

    if not ts_list:
        return torch.full((r, s, 1), INF, device=over.device)
    return torch.cat(ts_list, -1)


def shadow_blocked(scene: T.Scene, over, pos, live=None):
    """Blocked-from-light test, S light samples per receiver.

    world.rs:101-111 semantics per sample: the single nearest positive
    hit along the shadow ray decides via its shadow flag, and only when it
    lies closer than the light sample.

    over [R,3], pos [R|1,S,3] -> bool [R,S]. ``live`` masks rows whose
    result is discarded: their direction is parked to +z and their mesh
    cap is 0, so the kernel's gates reject them.
    """
    st = scene.static
    v = pos - over[:, None]                                 # [R,S,3]
    dist = torch.clamp_min(torch.sqrt(dot3(v, v)), 1e-12)   # [R,S]
    direction = v / dist[..., None]
    r, s = dist.shape[0], dist.shape[1]
    if live is not None:
        direction = torch.where(
            live[:, None, None], direction,
            T.small_const((0.0, 0.0, 1.0), over.device))

    ts = _shadow_static_ts(scene, over, direction)
    col_gid, col_gid_t = static_columns(scene, "shadow")
    if st.csg_nodes:
        ntc = st.n_csg_tris
        if ntc:
            # CSG triangles need dense columns (the parity filter must see
            # every hit); world-space vertices, so the sample axis is
            # flattened just here
            flat_o = over[:, None].expand(r, s, 3).reshape(-1, 3)
            tts, _, _ = _tri_moller_trumbore(
                flat_o, direction.reshape(-1, 3), scene.tri_p1[:ntc],
                scene.tri_e1[:ntc], scene.tri_e2[:ntc],
                det_eps=scene.tri_det_eps[:ntc])
            ts = torch.cat([ts, tts.reshape(r, s, ntc)], -1)
        c = ts.shape[-1]
        # the filter reads RAW ts (negative hits toggle containment), on
        # the flattened [R*S, C] table
        ts = apply_csg(scene, ts.reshape(r * s, c), col_gid, c).reshape(
            r, s, c)

    pos_ok = (ts > 0.0) & torch.isfinite(ts)
    masked = torch.where(pos_ok, ts, INF)
    slot = masked.argmin(-1)
    t_s = select_col(masked, slot)                          # [R,S]
    # per-column shadow flags are static rows (triangle gids map through
    # their source row), broadcast over rays and samples
    flag_cols = table_gather(scene.shadow, transform_row(scene, col_gid_t))
    flag_s = flag_cols[slot]

    if st.counts[5] - st.n_csg_tris > 0:
        flat_o = over[:, None].expand(r, s, 3).reshape(-1, 3)
        # Exact search cap: only the segment [0, min(t_s, dist)) can
        # change the verdict. Dead rows get cap 0 (never live).
        t_cap = torch.minimum(t_s, dist)
        if live is not None:
            t_cap = torch.where(live[:, None], t_cap, 0.0)
        # When every triangle source casts shadows, only the EXISTENCE of
        # a hit below the cap matters (any such hit blocks): any-hit mode.
        t_m, g_m, _, _ = _tri_free_nearest(
            scene, flat_o, direction.reshape(-1, 3),
            t_cap=t_cap.reshape(-1), any_hit=bool(st.mesh_all_shadow),
        )
        t_m = t_m.reshape(r, s)
        better = t_m < t_s
        if st.mesh_all_shadow:
            flag_m = torch.ones_like(better)
        else:
            flag_m = table_gather(scene.shadow,
                                  transform_row(scene, g_m.reshape(r, s)))
        flag_s = torch.where(better, flag_m, flag_s)
        t_s = torch.minimum(t_m, t_s)

    return torch.isfinite(t_s) & (t_s < dist) & flag_s


def candidate_meta(static: T.SceneStatic):
    """Static structure of the candidate column layout of
    :func:`candidate_hits`: per-column object id, and for every column the
    list of sibling columns belonging to the same object. Free-triangle
    columns each are their own object. Returns (obj_of_col int32 [C],
    siblings list[list[int]], c_static)."""
    cols = []
    for name, slots in _QUADRIC_SLOTS:
        off, n = static.family_range(name)
        for g in range(off, off + n):
            cols.extend([g] * slots)
    tri_off = sum(static.counts[:5])
    cols.extend(range(tri_off, tri_off + static.n_csg_tris))
    c_static = max(len(cols), 1)
    if not cols:
        cols = [0]

    nt_free = static.counts[5] - static.n_csg_tris
    # nearest-positive column, plus the nearest-behind column for
    # transparent meshes — must mirror candidate_hits' layout
    k = (1 + int(static.mesh_transparent)) if nt_free > 0 else 0
    next_obj = (max(cols) + 1) if cols else 0
    obj = np.asarray(cols + [next_obj + i for i in range(k)], np.int32)

    by_obj = {}
    for j, g in enumerate(cols):
        by_obj.setdefault(g, []).append(j)
    siblings = [
        [k2 for k2 in by_obj.get(int(obj[j]), []) if k2 != j]
        if j < len(cols) else []
        for j in range(len(obj))
    ]
    return obj, siblings, c_static


def first_hit(ts, gid, u, v):
    """hit() = intersection with the smallest t > 0 (intersections.rs:94-96),
    a masked argmin over the UNSORTED candidate table.

    Returns (has_hit [R], t [R], gid [R], u [R], v [R], hit_slot [R]).
    """
    pos = (ts > 0.0) & torch.isfinite(ts)
    masked = torch.where(pos, ts, INF)
    slot = masked.argmin(-1)
    has = pos.any(-1)
    take = lambda x: select_col(x, slot)  # noqa: E731
    return has, take(ts), take(gid), take(u), take(v), slot
