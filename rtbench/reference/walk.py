"""The plain reference of scenes with transparent meshes: tracer.py's
Whitted tracer with the n1/n2 container walk of intersections.rs:141-160
taken literally over meshes too.

The ported tracer walks the sorted list of every intersection of the ray,
negative ones included, up to the hit, and a triangle is an object of its
own: the walk opens a triangle's container where the line crosses it. So
this reference finds every crossing of the ray's whole line (t of either
sign) with every triangle, puts them beside the quadrics' intersections,
and walks them in order of t, each triangle its own container, as
tracer.py's ``_n1_n2`` walks the quadrics. It takes no shortcut through
the two mesh columns (nearest ahead, nearest behind) that the measured
program keeps: it is the yardstick of that shortcut. tracer.py refuses
such scenes; everything else is tracer.py's, by import.

The walk runs on the rays whose hit is transparent: elsewhere n1 and n2
move nothing (no refracted ray is spawned and no Schlick blend is taken).
A ray's crossings go into a list as wide as the most any ray of the batch
has, so none is dropped. Matrix products run with TF32 off. It imports
nothing but torch, numpy and tracer.py.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import tracer
from rtbench.reference.tracer import EPSILON, INF, _dot, _normalize


class Scene(tracer.Scene):
    """tracer.Scene's tables, built without its refusal of transparent
    meshes of another refractive index than 1, and with ``grp_real``
    [I, G, GROUP]: whether a group's entry is a triangle of its own and
    not the repeat that pads a small group."""

    def __init__(self, desc, *, device="cpu", dtype=torch.float32):
        insts = desc.get("instances", [])
        super().__init__(dict(desc, instances=[], meshes=[]), device=device,
                         dtype=dtype)
        self.desc = desc
        mats = [tracer.material(**m) for m in desc["materials"]]
        if any(mats[i["material"]]["pattern"] is not None for i in insts):
            raise NotImplementedError("patterns on meshes")
        dev = self.device
        self.obj_mat = torch.cat([self.obj_mat, torch.as_tensor(
            [i["material"] for i in insts], dtype=torch.long, device=dev)])
        self.obj_pat = torch.cat([self.obj_pat, torch.full(
            (len(insts),), -1, dtype=torch.long, device=dev)])
        self.obj_shadow = torch.cat([self.obj_shadow, torch.as_tensor(
            [bool(i.get("shadow", True)) for i in insts], dtype=torch.bool,
            device=dev)])

        def ten(x):
            return torch.as_tensor(np.asarray(x, np.float64)).to(
                device=dev, dtype=dtype)

        self._build_meshes(desc.get("meshes", []), insts, ten)
        if self.n_inst:
            real = torch.ones_like(self.grp_tri, dtype=torch.bool)
            real[..., 1:] = self.grp_tri[..., 1:] != self.grp_tri[..., :1]
            self.grp_real = real


def line_crossings(sc, o, d):
    """Every crossing of the whole lines o + t d (t of either sign) with
    every triangle: the instances' and the groups' boxes are tested on the
    whole line, then every triangle of each group it meets. No gradient.
    Returns (ray [P], t [P], object [P]), sorted by ray, then object: the
    triangle k of instance i is the object n_quad + i N + k (N triangles
    an instance)."""
    dev = o.device
    rays, ts, objs = [], [], []
    n = sc.tri_p1.shape[1] if sc.n_inst else 0
    with torch.no_grad():
        o, d = o.detach(), d.detach()
        safe = torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
        inv_d = 1.0 / safe
        for i in range(sc.n_inst):
            tn, tf = tracer._slab(sc.inst_box[i, 0], sc.inst_box[i, 1], o,
                                  inv_d)
            rows = torch.nonzero(tn <= tf)[:, 0]
            for blk in rows.split(tracer.BOX_BLOCK):
                tn, tf = tracer._slab(sc.grp_box[i, :, 0],
                                      sc.grp_box[i, :, 1], o[blk, None],
                                      inv_d[blk, None])
                ray, grp = torch.nonzero(tn <= tf, as_tuple=True)
                for s in range(0, ray.numel(), tracer.PAIR_BLOCK):
                    rr = blk[ray[s:s + tracer.PAIR_BLOCK]]
                    g = grp[s:s + tracer.PAIR_BLOCK]
                    ids = sc.grp_tri[i, g]
                    t = tracer._moller_trumbore(
                        o[rr], d[rr], sc.tri_p1[i, ids], sc.tri_e1[i, ids],
                        sc.tri_e2[i, ids], sc.tri_eps[i])
                    pr, pk = torch.nonzero(
                        torch.isfinite(t) & sc.grp_real[i, g], as_tuple=True)
                    rays.append(rr[pr])
                    ts.append(t[pr, pk])
                    objs.append(sc.n_quad + i * n + ids[pr, pk])
    if not rays:
        empty = torch.zeros((0,), dtype=torch.long, device=dev)
        return empty, o.new_zeros((0,)), empty
    ray, t, obj = torch.cat(rays), torch.cat(ts), torch.cat(objs)
    order = torch.argsort(ray * (sc.n_quad + sc.n_inst * n) + obj)
    return ray[order], t[order], obj[order]


def crossing_lists(sc, o, d):
    """:func:`line_crossings` as lists a ray, as wide as the longest (one
    at the least): (t [R, K] (inf past a ray's last), object [R, K] (-1
    there), the refractive index of each [R, K]), each ray's crossings in
    the order of their objects."""
    r = o.shape[0]
    ray, t, obj = line_crossings(sc, o, d)
    counts = torch.bincount(ray, minlength=r)
    k = max(int(counts.max()) if r else 0, 1)
    pos = torch.arange(ray.numel(), device=o.device) - (
        counts.cumsum(0) - counts)[ray]
    ts = o.new_full((r, k), INF)
    objs = torch.full((r, k), -1, dtype=torch.long, device=o.device)
    ts[ray, pos] = t
    objs[ray, pos] = obj
    n = sc.tri_p1.shape[1] if sc.n_inst else 1
    # a padding entry (object -1) reads the last object's index, unused
    scene_obj = (sc.n_quad + (objs - sc.n_quad).clamp_min(0) // n).clamp_max(
        sc.obj_mat.numel() - 1)
    ri = sc.params["mat.refractive_index"][sc.obj_mat[scene_obj]]
    return ts, objs, ri


def container_walk(ts, obj, ri, hit):
    """intersections.rs:141-160 on lists a ray: ``ts`` [R, C] (inf: no
    entry), ``obj`` [R, C] the object each entry crosses, ``ri`` [R, C] its
    refractive index, ``hit`` [R] the column of the hit. The entries are
    walked in order of t (ties in column order) up to the hit, an object's
    container toggled at each of its entries, as tracer._n1_n2 walks the
    quadrics: (n1 [R], n2 [R])."""
    r, c = ts.shape
    dev = ts.device
    valid = torch.isfinite(ts)
    order = torch.argsort(torch.where(valid, ts, INF), dim=-1, stable=True)
    # an object's container lives in the first column that holds it
    so, si = torch.sort(obj, dim=-1, stable=True)
    first = torch.ones_like(so, dtype=torch.bool)
    first[:, 1:] = so[:, 1:] != so[:, :-1]
    pos = torch.arange(c, device=dev).expand(r, c)
    head = torch.where(first, pos, 0).cummax(-1).values
    slot = torch.empty_like(si).scatter_(-1, si, si.gather(-1, head))
    steps = int((order == hit[:, None]).int().argmax(-1).max()) + 1 if r \
        else 0
    inside = torch.zeros((r, c), dtype=torch.bool, device=dev)
    entered = torch.zeros((r, c), dtype=torch.long, device=dev)
    one = torch.ones((r,), dtype=ri.dtype, device=dev)
    n1, n2 = one, one
    done = torch.zeros((r,), dtype=torch.bool, device=dev)
    rows = torch.arange(r, device=dev)

    def last():
        key = torch.where(inside, entered, -1)
        k, j = key.max(-1)
        return torch.where(k >= 0, ri[rows, j.clamp_min(0)], one)

    for step in range(steps):
        col = order[:, step]
        ok = valid[rows, col] & ~done
        is_hit = ok & (col == hit)
        n1 = torch.where(is_hit, last(), n1)
        s = slot[rows, col]
        was = inside[rows, s]
        inside[rows, s] = torch.where(ok, ~was, was)
        entered[rows, s] = torch.where(ok & ~was, step, entered[rows, s])
        n2 = torch.where(is_hit, last(), n2)
        done = done | is_hit
    return n1, n2


def indices(sc, o, d, ts, objs, slot, tri_obj):
    """n1 and n2 of rays o, d [R, 3] from the walk over their quadrics'
    intersections (``ts`` [R, Cq] of tracer.quadric_ts, the object of each
    column ``objs``) and their lines' triangle crossings, up to the hit:
    the triangle ``tri_obj`` [R] (its object number, see
    :func:`line_crossings`), or where that is -1 the quadric column
    ``slot`` [R]."""
    r = o.shape[0]
    ri_mat = sc.params["mat.refractive_index"]
    q_obj = torch.as_tensor(objs, dtype=torch.long, device=o.device)
    q_ri = ri_mat[sc.obj_mat[q_obj.clamp(0, max(sc.n_quad - 1, 0))]]
    t_tri, obj_tri, ri_tri = crossing_lists(sc, o, d)
    on_tri = tri_obj >= 0
    match = obj_tri == tri_obj[:, None]
    if bool((on_tri & ~match.any(-1)).any()):
        raise RuntimeError("a ray's hit triangle is not among its line's "
                           "crossings")
    hit = torch.where(on_tri, ts.shape[1] + match.int().argmax(-1), slot)
    return container_walk(
        torch.cat([ts, t_tri], -1), torch.cat([q_obj.expand(r, -1), obj_tri],
                                              -1),
        torch.cat([q_ri.expand(r, -1), ri_tri], -1), hit)


def nearest(sc, o, d):
    """The hit as tracer.shade finds it: (the quadrics' ts [R, Cq], the
    object of each column, the nearest positive quadric column [R], its t
    [R] (inf: none), tracer.mesh_nearest's t, instance and triangle capped
    at that t (inf, -1 and 0 where no triangle is nearer), and that
    triangle's object number (see :func:`line_crossings`; -1 there))."""
    ts, objs = tracer.quadric_ts(sc, o, d)
    masked = torch.where(ts > 0, ts, INF)
    t_q, slot = masked.detach().min(-1)
    t_q = torch.gather(masked, 1, slot[:, None])[:, 0]
    t_m, inst, tri = tracer.mesh_nearest(sc, o, d, t_q.detach())
    n = sc.tri_p1.shape[1] if sc.n_inst else 0
    tri_obj = torch.where(torch.isfinite(t_m), sc.n_quad + inst * n + tri,
                          -1)
    return ts, objs, slot, t_q, t_m, inst, tri, tri_obj


def refraction_indices(sc, o, d):
    """(has [R], n1 [R], n2 [R]) of rays o, d: whether each hits, and the
    walk's indices at its hit (1 where there is none)."""
    ts, objs, slot, t_q, t_m, _, _, tri_obj = nearest(sc, o, d)
    has = torch.isfinite(t_q) | torch.isfinite(t_m)
    one = torch.ones_like(t_q)
    rows = torch.nonzero(has)[:, 0]
    n1, n2 = indices(sc, o[rows], d[rows], ts[rows], objs, slot[rows],
                     tri_obj[rows])
    return has, one.index_put((rows,), n1), one.index_put((rows,), n2)


def shade(sc, o, d, w):
    """tracer.shade, with n1 and n2 from :func:`indices` on the rays whose
    hit is transparent."""
    p = sc.params
    ts, objs, slot, t_q, t_m, inst, tri, tri_obj = nearest(sc, o, d)
    objs_t = torch.as_tensor(objs, dtype=torch.long, device=o.device)
    obj = objs_t[slot]
    t = t_q
    rows = torch.nonzero(torch.isfinite(t_m))[:, 0]
    if rows.numel():
        t_w, u, v, (n1v, n2v, n3v) = tracer._winner(
            sc, o[rows], d[rows], inst[rows], tri[rows])
        t = t_q.index_put((rows,), t_w)
        obj = obj.index_put((rows,), sc.n_quad + inst[rows])
    has = torch.isfinite(t.detach())
    t = torch.where(has, t, torch.ones_like(t))
    obj = torch.where(has, obj, torch.zeros_like(obj))
    point = o + t[:, None] * d
    eyev = -d
    q = obj.clamp(0, max(sc.n_quad - 1, 0))
    if sc.n_quad:
        normalv = tracer._quadric_normal(sc, q, point)
    else:
        normalv = torch.zeros_like(point)
    if rows.numel():
        uu, vv = u[:, None], v[:, None]
        interp = uu * n2v + vv * n3v + (1.0 - uu - vv) * n1v
        normalv = normalv.index_put((rows,), _normalize(interp))
    flip = _dot(normalv, eyev) < 0
    normalv = torch.where(flip[:, None], -normalv, normalv)
    over = point + EPSILON * normalv
    under = point - EPSILON * normalv

    mi = sc.obj_mat[obj]
    color = p["mat.color"][mi]
    pat = sc.obj_pat[obj]
    if p["pat_a"].shape[0]:
        chk = tracer._checker(sc, pat.clamp_min(0), q, over)
        color = torch.where((pat >= 0)[:, None], chk, color)

    def col(f):
        return p[f"mat.{f}"][mi]

    surface = torch.zeros_like(color)
    n_lights = p["plight_pos"].shape[0]
    for li in range(n_lights):
        lpos, lint = p["plight_pos"][li], p["plight_intensity"][li]
        eff = color * lint
        ambient = eff * col("ambient")[:, None]
        lightv = _normalize(lpos[None] - over)
        ldn = _dot(lightv, normalv)
        lit = ldn >= 0
        diffuse = eff * col("diffuse")[:, None] * ldn[:, None]
        reflectv = -lightv - 2.0 * _dot(-lightv, normalv)[:, None] * normalv
        rde = _dot(reflectv, eyev)
        spec_on = lit & (rde > 0)
        factor = torch.pow(rde.clamp_min(0), col("shininess"))
        specular = lint * (col("specular") * factor)[:, None]
        ds = torch.where(lit[:, None], diffuse, 0.0) + torch.where(
            spec_on[:, None], specular, 0.0)
        blocked = tracer._shadowed(sc, over.detach(), lpos.detach())
        surface = surface + ambient + torch.where(blocked[:, None], 0.0, ds)
    surface = torch.where(has[:, None], surface, 0.0)

    reflective, transparency = col("reflective"), col("transparency")
    n1 = n2 = torch.ones_like(t)
    if not sc.all_ri_one:
        clear = torch.nonzero(has & (transparency.detach() > 0))[:, 0]
        if clear.numel():
            c1, c2 = indices(sc, o[clear], d[clear], ts[clear], objs,
                             slot[clear], tri_obj[clear])
            n1, n2 = n1.index_put((clear,), c1), n2.index_put((clear,), c2)
    cos = _dot(eyev, normalv)
    n = n1 / n2
    sin2_t = n * n * (1.0 - cos * cos)
    cos_t = torch.sqrt((1.0 - sin2_t).clamp_min(1e-10))
    cos_eff = torch.where(n1 > n2, cos_t, cos)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - cos_eff) ** 5
    schlick = torch.where((n1 > n2) & (sin2_t > 1.0), 1.0, schlick)
    blend = (reflective > 0) & (transparency > 0)
    refl_f = torch.where(blend, schlick, 1.0)
    refr_f = torch.where(blend, 1.0 - schlick, 1.0)
    reflectv = d - 2.0 * _dot(d, normalv)[:, None] * normalv
    w_refl = w * torch.where(has, reflective * refl_f * n_lights,
                             0.0)[:, None]
    tir = sin2_t > 1.0
    refr = (n * cos - cos_t)[:, None] * normalv - n[:, None] * eyev
    refr = _normalize(refr)
    w_refr = w * torch.where(has & ~tir, transparency * refr_f * n_lights,
                             0.0)[:, None]
    return w * surface, (over, reflectv, w_refl), (under, refr, w_refr)


def trace(sc, o, d):
    """tracer.trace with :func:`shade`: colours [R, 3] of the rays."""
    r = o.shape[0]
    img = torch.zeros((r, 3), dtype=sc.dtype, device=o.device)
    pix = torch.arange(r, device=o.device)
    w = torch.ones((r, 3), dtype=sc.dtype, device=o.device)
    for level in range(sc.limit + 1):
        if o.shape[0] == 0:
            break
        colored, refl, refr = shade(sc, o, d, w)
        img = img.index_add(0, pix, colored)
        if level == sc.limit:
            break
        nxt = []
        for so, sd, sw in (refl, refr):
            live = (sw.detach() > 0).any(-1)
            nxt.append((so[live], sd[live], sw[live], pix[live]))
        o = torch.cat([x[0] for x in nxt])
        d = torch.cat([x[1] for x in nxt])
        w = torch.cat([x[2] for x in nxt])
        pix = torch.cat([x[3] for x in nxt])
    return img


def render_u8(sc):
    """The scene's frame [vsize, hsize, 3] uint8 (numpy), in blocks of
    tracer.RAY_BLOCK rays, with TF32 off."""
    cam = sc.desc["camera"]
    h, v = int(cam["hsize"]), int(cam["vsize"])
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    try:
        with torch.no_grad():
            for start in range(0, h * v, tracer.RAY_BLOCK):
                pix = torch.arange(start, min(start + tracer.RAY_BLOCK,
                                              h * v), device=sc.device)
                o, d = tracer.camera_rays(cam, device=sc.device,
                                          dtype=sc.dtype, pixels=pix)
                out.append(tracer.quantize_u8(trace(sc, o, d)).cpu())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return torch.cat(out).numpy().reshape(v, h, 3)
