"""Normals, Phong lighting, Fresnel and the refraction-index walk.

Counterpart of ``raytracer_tpu/core/shading.py``: materials.rs::lighting,
intersections.rs::Computations::prepare / schlick and world.rs shading
semantics, vectorized over ray batches.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.constants import EPSILON
from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.core.intersect import (
    candidate_meta, dot3, mat3_apply, select_col, transform_row,
)


def reflect(v, n):
    """tuples.rs:250-254: v - 2*dot(v,n)*n."""
    return v - 2.0 * dot3(v, n)[..., None] * n


def normalize(v):
    # clamped: the dummy normal of a missed ray must not divide by zero
    return v / torch.clamp_min(torch.sqrt(dot3(v, v)), 1e-12)[..., None]


def normal_at(scene: T.Scene, gid, world_point, u, v, tgid=None, inv=None,
              nmat=None):
    """shapes.rs:187-202: world_to_object -> local_normal_at -> world.

    Every family's formula is evaluated and where-selected by static gid
    ranges. ``tgid``/``inv``/``nmat``: precomputed compact rows and
    per-ray transform matrices shared with the caller's lookups.
    """
    st = scene.static
    off = st.offsets
    ns, npl, ncu, ncy, nco, nt = st.counts
    dev = world_point.device

    if tgid is None:
        tgid = transform_row(scene, gid)
    if inv is None:
        inv = scene.inv_tf[tgid]
    lp = mat3_apply(inv[:, :3, :3], world_point) + inv[:, :3, 3]
    lx, ly, lz = lp[:, 0], lp[:, 1], lp[:, 2]

    # sphere.rs:82-84: p - origin
    n_local = lp

    # plane.rs:75-77
    up = T.small_const((0.0, 1.0, 0.0), dev)
    plane_n = up.expand(lp.shape)

    # cube.rs:116-133: dominant axis, x-then-y-then-z tie-break
    maxc = torch.maximum(torch.maximum(lx.abs(), ly.abs()), lz.abs())
    zeros = torch.zeros_like(lx)
    cube_n = torch.stack([zeros, zeros, lz], -1)
    cube_n = torch.where((ly.abs() == maxc)[:, None],
                         torch.stack([zeros, ly, zeros], -1), cube_n)
    cube_n = torch.where((lx.abs() == maxc)[:, None],
                         torch.stack([lx, zeros, zeros], -1), cube_n)

    # cylinder.rs:158-167 caps within EPSILON bands
    def capped_normal(local_idx, mins, maxs, side_n):
        mn = mins[local_idx]
        mx = maxs[local_idx]
        dist = lx * lx + lz * lz
        top = (dist < 1.0) & (ly >= mx - EPSILON)
        bot = (dist < 1.0) & (ly <= mn + EPSILON)
        n = torch.where(top[:, None], up, side_n)
        n = torch.where(bot[:, None], -up, n)
        return n

    if ncy:
        cyl_idx = (gid - off[3]).clamp(0, ncy - 1)
        cyl_side = torch.stack([lx, zeros, lz], -1)
        cyl_n = capped_normal(cyl_idx, scene.cyl_min, scene.cyl_max, cyl_side)
    else:
        cyl_n = n_local
    if nco:
        cone_idx = (gid - off[4]).clamp(0, nco - 1)
        # cone.rs:167-180: y = -sign(ly)*sqrt(x^2+z^2)
        yy = torch.sqrt(lx * lx + lz * lz)
        yy = torch.where(ly > 0.0, -yy, yy)
        cone_side = torch.stack([lx, yy, lz], -1)
        cone_n = capped_normal(cone_idx, scene.cone_min, scene.cone_max,
                               cone_side)
    else:
        cone_n = n_local

    local = n_local
    for fam_i, n_fam in ((1, plane_n), (2, cube_n), (3, cyl_n), (4, cone_n)):
        lo = off[fam_i]
        hi = lo + st.counts[fam_i]
        in_fam = (gid >= lo) & (gid < hi)
        local = torch.where(in_fam[:, None], n_fam, local)

    # non-triangle: local normal -> world via normal matrix + normalize
    if nmat is None:
        nmat = scene.normal_mat[tgid]
    world_n = normalize(mat3_apply(nmat, local))

    # triangles: stored world-space normals
    if nt:
        tri_lo = off[5]
        tidx = (gid - tri_lo).clamp(0, nt - 1)
        row = scene.tri_shade[tidx]                        # [R, 13]
        interp = (
            u[:, None] * row[:, 3:6]
            + v[:, None] * row[:, 6:9]
            + (1.0 - u - v)[:, None] * row[:, 0:3]
        )
        tri_n = torch.where(row[:, 12:13] != 0.0, normalize(interp),
                            row[:, 9:12])
        world_n = torch.where((gid >= tri_lo)[:, None], tri_n, world_n)

    return world_n


def phong(mat_rows, surface_color, light_intensity, light_pos, point, eyev,
          normalv):
    """One Phong sample (materials.rs:101-135 core): returns
    (diffuse+specular) [..., 3]; ambient handled by the caller."""
    diffuse_f = mat_rows[..., T.MAT_DIFFUSE : T.MAT_DIFFUSE + 1]
    specular_f = mat_rows[..., T.MAT_SPECULAR : T.MAT_SPECULAR + 1]
    shininess = mat_rows[..., T.MAT_SHININESS]

    eff = surface_color * light_intensity
    lightv = normalize(light_pos - point)
    ldn = dot3(lightv, normalv)
    lit = ldn >= 0.0

    diffuse = eff * diffuse_f * ldn[..., None]

    reflectv = reflect(-lightv, normalv)
    rde = dot3(reflectv, eyev)
    spec_on = lit & (rde > 0.0)
    factor = torch.pow(torch.clamp_min(rde, 0.0), shininess)
    specular = light_intensity * specular_f * factor[..., None]

    out = torch.where(lit[..., None], diffuse, 0.0)
    out = out + torch.where(spec_on[..., None], specular, 0.0)
    return out


def schlick(eyev, normalv, n1, n2):
    """intersections.rs:177-192 Fresnel approximation."""
    cos = dot3(eyev, normalv)
    n = n1 / n2
    sin2_t = n * n * (1.0 - cos * cos)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-10))
    cos_eff = torch.where(n1 > n2, cos_t, cos)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    r = r0 + (1.0 - r0) * (1.0 - cos_eff) ** 5
    tir = (n1 > n2) & (sin2_t > 1.0)
    return torch.where(tir, 1.0, r)


def _walk_tables(scene: T.Scene):
    """The static tables of :func:`refraction_indices_fast`, made once per
    scene from ``candidate_meta``: the column count, the dynamic (free
    mesh) columns, the static columns' objects, the sibling-or-self matrix
    [C, C] as f32, the columns with siblings (ks, js, their [k, j] sibling
    mask; None when no column has one) and every column's object."""
    def build():
        obj_np, siblings, c_static = candidate_meta(scene.static)
        c = len(obj_np)
        dev = scene.device
        n_dyn = c - min(c_static, c)
        sib_m = np.zeros((c, c), bool)          # [k, j]: k sibling of j
        for j in range(c):
            for k in siblings[j]:
                sib_m[k, j] = True
        ks = np.nonzero(sib_m.any(axis=1))[0]
        js = np.nonzero(sib_m.any(axis=0))[0]
        sup = None
        if len(ks):
            sup = (torch.as_tensor(ks, device=dev),
                   torch.as_tensor(js, device=dev),
                   torch.as_tensor(sib_m[np.ix_(ks, js)], device=dev))
        return dict(
            c=c, n_dyn=n_dyn,
            static_obj=torch.as_tensor(obj_np[: c - n_dyn], device=dev).long(),
            cnt_m=torch.as_tensor(sib_m | np.eye(c, dtype=bool),
                                  device=dev).to(torch.float32),
            sup=sup, obj_cols=torch.as_tensor(obj_np, device=dev))

    return scene.const("walk", build)


def refraction_indices_fast(scene: T.Scene, ts, gids, hit_slot):
    """n1/n2 container walk specialized to the canonical candidate layout
    of intersect.candidate_hits (unsorted, column->object map static).

    Same math as :func:`refraction_indices`, but sibling columns of each
    object are known ahead of time (:func:`_walk_tables`), so parity and
    latest-toggle checks need no [R, C, C] tensor over all columns.
    """
    tab = _walk_tables(scene)
    c = ts.shape[-1]
    if tab["c"] != c:
        raise ValueError(f"candidate layout has {tab['c']} columns, "
                         f"table has {c}")
    dev = ts.device
    r = ts.shape[0]
    idx = torch.arange(c, device=dev)
    valid = torch.isfinite(ts)
    # Column -> refractive index: static columns from one [C_static]
    # lookup; free-mesh columns per ray unless every mesh source shares
    # one refractive index.
    mat_refr = scene.mat[:, T.MAT_REFRACTIVE]              # [M]
    n_dyn = tab["n_dyn"]
    static_rows = transform_row(scene, tab["static_obj"])
    refr_static = mat_refr[scene.mat_id[static_rows].long()][None, :].expand(
        r, c - n_dyn)
    if n_dyn:
        uni = scene.static.mesh_uniform_refr
        if uni is not None:
            dyn_cols = [torch.full((r, 1), float(uni), device=dev)] * n_dyn
        else:
            dyn_cols = [
                mat_refr[scene.mat_id[
                    transform_row(scene, gids[:, j].long())].long()][:, None]
                for j in range(c - n_dyn, c)
            ]
        refr = torch.cat([refr_static] + dyn_cols, -1)
    else:
        refr = refr_static

    t_h = select_col(ts, hit_slot)[:, None]                # [R, 1]
    before = valid & (
        (ts < t_h) | ((ts == t_h) & (idx[None, :] < hit_slot[:, None]))
    )                                                      # [R, C]

    # per-column toggle count of its object: an f32 product of 0/1
    # matrices, exact for these small integer sums
    cnt = (before.to(torch.float32) @ tab["cnt_m"]).to(torch.int32)
    superseded = torch.zeros_like(before)
    if tab["sup"] is not None:
        ks_t, js_t, sib_kj = tab["sup"]
        ts_k = ts[:, ks_t][:, :, None]
        ts_j = ts[:, js_t][:, None, :]
        later = (ts_k > ts_j) | (
            (ts_k == ts_j) & (ks_t[:, None] > js_t[None, :])[None]
        )                                       # [R, k, j]
        sup_js = (
            sib_kj[None] & before[:, ks_t, None] & later
        ).any(1)                                # [R, len(js)]
        superseded[:, js_t] = sup_js
    open_col = (cnt % 2) == 1
    live = before & ~superseded & open_col

    def latest(mask):
        big_t = torch.where(mask, ts, -float("inf"))
        m = big_t.amax(-1, keepdim=True)
        at_max = mask & (big_t == m)
        j = torch.where(at_max, idx[None, :], -1).amax(-1)
        ri = select_col(refr, j.clamp_min(0))
        return torch.where(j >= 0, ri, 1.0)

    n1 = latest(live)

    obj_cols = tab["obj_cols"]
    obj_h = obj_cols[hit_slot][:, None]                    # [R, 1]
    h_was_open = select_col(open_col, hit_slot)
    refr_h = select_col(refr, hit_slot)
    n2_closed_h = latest(live & (obj_cols[None, :] != obj_h))
    n2 = torch.where(h_was_open, n2_closed_h, refr_h)
    return n1, n2


def refraction_indices(scene: T.Scene, ts, gids, hit_slot):
    """n1/n2 via the container walk (intersections.rs:141-160), computed
    directly on the unsorted candidate table by pairwise (t, slot) keys —
    the oracle of :func:`refraction_indices_fast`."""
    c = ts.shape[-1]
    idx = torch.arange(c, device=ts.device)
    valid = torch.isfinite(ts)
    refr = scene.mat[scene.mat_id[transform_row(scene, gids.long())].long(),
                     T.MAT_REFRACTIVE]                     # [R, C]

    t_h = select_col(ts, hit_slot)[:, None]                # [R, 1]
    before = valid & (
        (ts < t_h) | ((ts == t_h) & (idx[None, :] < hit_slot[:, None]))
    )                                                      # [R, C]

    same = gids[:, :, None] == gids[:, None, :]            # [R, j, k]
    b_k = before[:, None, :]                               # [R, 1, k]
    cnt = (same & b_k).sum(-1)                             # [R, j]
    open_g = (cnt % 2) == 1

    key_gt = (ts[:, None, :] > ts[:, :, None]) | (
        (ts[:, None, :] == ts[:, :, None])
        & (idx[None, None, :] > idx[None, :, None])
    )
    superseded = (same & b_k & key_gt).any(-1)             # [R, j]
    live_push = before & ~superseded & open_g

    def latest(mask):
        big_t = torch.where(mask, ts, -float("inf"))
        m = big_t.amax(-1, keepdim=True)
        at_max = mask & (big_t == m)
        j = torch.where(at_max, idx[None, :], -1).amax(-1)
        ri = select_col(refr, j.clamp_min(0))
        return torch.where(j >= 0, ri, 1.0)

    n1 = latest(live_push)

    gid_h = select_col(gids, hit_slot)[:, None]
    cnt_h = ((gids == gid_h) & before).sum(-1)
    h_was_open = (cnt_h % 2) == 1
    refr_h = select_col(refr, hit_slot)
    n2_closed_h = latest(live_push & (gids != gid_h))
    n2 = torch.where(h_was_open, n2_closed_h, refr_h)
    return n1, n2
