"""A plain Whitted ray tracer in PyTorch: the yardstick of `correct`.

It follows the semantics of the Rust ray tracer of *The Ray Tracer
Challenge* (lerouxrgd/raytracer) that the measured program ports, written
out the straightforward way: rays in batches, every quadric tested, mesh
triangles tested by brute force behind a box per instance and a box per
group of at most GROUP triangles (median splits, as groups.rs divides), the
bounce tree walked level by level with the path weights. It imports
nothing but torch and numpy, and builds everything it uses from the plain
scene description that a configuration module makes (``describe``):

    {"camera": {"hsize", "vsize", "fov", "from", "to", "up"},
     "lights": [{"position", "intensity"}],
     "materials": [{"color", "ambient", "diffuse", "specular", "shininess",
                    "reflective", "transparency", "refractive_index",
                    "pattern": None | {"kind": "checker", "a", "b",
                                       "transform"}}],
     "shapes": [{"kind": "sphere" | "plane" | "cube" | "cylinder",
                 "transform" (4x4, world), "material", "shadow",
                 "min", "max", "closed" (cylinders)}],
     "meshes": [{"p": [N, 3, 3], "n": [N, 3, 3]}]      (object space),
     "instances": [{"mesh", "transform" (4x4, world), "material",
                    "shadow"}],
     "recursion_limit": 4}

Every computation runs in ``dtype`` (float32 for the check; a lower one
for the control), on ``device``. The shading is differentiable with
respect to the scene's float tables (``Scene.params``) and to the rays.

Semantics kept from the ported tracer, each a choice of the Rust code:
the nearest hit is the smallest t > 0; a shadow ray is blocked when the
nearest positive hit along it lies before the light and that object casts
shadows (an object that casts none hides what lies behind it); reflected
and refracted light is added once per light; over and under points lie
EPSILON along the normal flipped towards the eye; patterns are read at the
over point; refracted directions are normalised; the mesh's Moller-Trumbore
test rejects |det| under EPSILON times the instance's |det A| (the object
space test, carried into world space); n1 and n2 come from the container
walk over every intersection of the ray, negative ones included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPSILON = 1e-4
INF = float("inf")
KINDS = ("sphere", "plane", "cube", "cylinder")
MAT_FIELDS = ("ambient", "diffuse", "specular", "shininess", "reflective",
              "transparency", "refractive_index")
DEFAULT_MATERIAL = dict(color=(1.0, 1.0, 1.0), ambient=0.1, diffuse=0.9,
                        specular=0.9, shininess=200.0, reflective=0.0,
                        transparency=0.0, refractive_index=1.0, pattern=None)
RAY_BLOCK = 262144     # rays a block when rendering a frame
GROUP = 64             # triangles a group, the unit of the mesh's culling
BOX_BLOCK = 2048       # rays a block against one instance's group boxes
PAIR_BLOCK = 32768     # (ray, group) pairs a block against their triangles


def material(**kw):
    """A material description with the book's defaults."""
    out = dict(DEFAULT_MATERIAL)
    out.update(kw)
    return out


# ------------------------------------------------------------------ scene

class Scene:
    """The reference's own tables, built from a scene description.

    ``params``: the float tables that a training step moves, by name:
    ``mat.color`` [M, 3], ``mat.<field>`` [M] for each of MAT_FIELDS,
    ``plight_pos`` and ``plight_intensity`` [L, 3], ``pat_a`` and
    ``pat_b`` [P, 3]. ``with_params`` gives a scene that reads other
    tensors in their place."""

    def __init__(self, desc, *, device="cpu", dtype=torch.float32):
        self.desc = desc
        self.device = torch.device(device)
        self.dtype = dtype
        self.limit = int(desc.get("recursion_limit", 4))

        def ten(x):
            return torch.as_tensor(np.asarray(x, np.float64)).to(
                device=self.device, dtype=dtype)

        mats = [material(**m) for m in desc["materials"]]
        pats = [m["pattern"] for m in mats if m["pattern"] is not None]
        for p in pats:
            if p["kind"] != "checker":
                raise NotImplementedError(f"pattern {p['kind']}")
        self.params = {"mat.color": ten([m["color"] for m in mats])}
        for f in MAT_FIELDS:
            self.params[f"mat.{f}"] = ten([m[f] for m in mats])
        self.params["plight_pos"] = ten(
            [lt["position"] for lt in desc["lights"]]).reshape(-1, 3)
        self.params["plight_intensity"] = ten(
            [lt.get("intensity", (1.0, 1.0, 1.0))
             for lt in desc["lights"]]).reshape(-1, 3)
        self.params["pat_a"] = ten([p["a"] for p in pats]).reshape(-1, 3)
        self.params["pat_b"] = ten([p["b"] for p in pats]).reshape(-1, 3)
        pat_of_mat, k = [], 0
        for m in mats:
            pat_of_mat.append(-1 if m["pattern"] is None else k)
            k += m["pattern"] is not None
        pat_inv = [np.linalg.inv(np.asarray(p["transform"], np.float64))
                   for p in pats]
        self.pat_inv = ten(np.stack(pat_inv) if pat_inv
                           else np.zeros((0, 4, 4)))

        # objects: the quadrics, then the mesh instances
        shapes = desc.get("shapes", [])
        insts = desc.get("instances", [])
        self.n_quad = len(shapes)
        mat_of = [s["material"] for s in shapes] + [i["material"]
                                                    for i in insts]
        self.obj_mat = torch.as_tensor(mat_of, dtype=torch.long,
                                       device=self.device)
        self.obj_pat = torch.as_tensor(
            [pat_of_mat[m] for m in mat_of], dtype=torch.long,
            device=self.device)
        self.obj_shadow = torch.as_tensor(
            [bool(s.get("shadow", True)) for s in shapes]
            + [bool(i.get("shadow", True)) for i in insts],
            device=self.device)
        if insts and bool((self.obj_pat[self.n_quad:] >= 0).any()):
            raise NotImplementedError("patterns on meshes")

        m_q = np.stack([np.asarray(s["transform"], np.float64)
                        for s in shapes]) if shapes else np.zeros((0, 4, 4))
        inv_q = np.linalg.inv(m_q) if shapes else m_q
        self.q_kind = [KINDS.index(s["kind"]) for s in shapes]
        self.q_inv = ten(inv_q)
        self.q_nmat = ten(np.transpose(inv_q, (0, 2, 1))[:, :3, :3])
        self.q_min = ten([s.get("min", -INF) for s in shapes])
        self.q_max = ten([s.get("max", INF) for s in shapes])
        self.q_closed = [bool(s.get("closed", False)) for s in shapes]
        self.q_kind_t = torch.as_tensor(self.q_kind, dtype=torch.long,
                                        device=self.device)

        self._build_meshes(desc.get("meshes", []), insts, ten)
        self.all_ri_one = all(m["refractive_index"] == 1.0 for m in mats)
        if insts and not self.all_ri_one and any(
                mats[i["material"]]["transparency"] > 0 for i in insts):
            raise NotImplementedError("transparent meshes of another "
                                      "refractive index than 1")

    def _build_meshes(self, meshes, insts, ten):
        """World-space triangles per instance, in f64 then ``dtype``:
        p1, e1, e2 and the three vertex normals, each [I, N, 3]; the
        det threshold [I]; each instance's world box [I, 2, 3]; its
        mesh's groups of triangle ids [I, G, GROUP] and their world boxes
        [I, G, 2, 3]."""
        self.n_inst = len(insts)
        if not insts:
            return
        sizes = {m["p"].shape[0] for m in meshes}
        if len(sizes) != 1:
            raise NotImplementedError("meshes of different sizes")
        groups = [split_groups(np.asarray(m["p"], np.float64).mean(1))
                  for m in meshes]
        cols = {k: [] for k in ("p1", "e1", "e2", "n1", "n2", "n3")}
        eps, lo, hi, grp, grp_lo, grp_hi = [], [], [], [], [], []
        for inst in insts:
            mesh = meshes[inst["mesh"]]
            m = np.asarray(inst["transform"], np.float64)
            p = np.asarray(mesh["p"], np.float64)
            w = p @ m[:3, :3].T + m[:3, 3]
            nm = np.linalg.inv(m).T[:3, :3]
            n = np.asarray(mesh["n"], np.float64) @ nm.T
            cols["p1"].append(w[:, 0])
            cols["e1"].append(w[:, 1] - w[:, 0])
            cols["e2"].append(w[:, 2] - w[:, 0])
            for j in range(3):
                cols[f"n{j + 1}"].append(n[:, j])
            eps.append(EPSILON * abs(np.linalg.det(m[:3, :3])))
            flat = w.reshape(-1, 3)
            pad = 1e-3 * (1.0 + np.abs(flat).max())
            lo.append(flat.min(0) - pad)
            hi.append(flat.max(0) + pad)
            g = groups[inst["mesh"]]
            grp.append(g)
            grp_lo.append(w[g].min(axis=(1, 2)) - pad)
            grp_hi.append(w[g].max(axis=(1, 2)) + pad)
        for k, v in cols.items():
            setattr(self, "tri_" + k, ten(np.stack(v)))
        self.tri_eps = ten(eps)
        self.inst_box = ten(np.stack([np.stack(lo), np.stack(hi)], 1))
        self.grp_tri = torch.as_tensor(np.stack(grp), device=self.device)
        self.grp_box = ten(np.stack([np.stack(grp_lo), np.stack(grp_hi)], 2))

    def with_params(self, params):
        """A shallow copy that reads ``params`` in place of its own."""
        out = object.__new__(Scene)
        out.__dict__.update(self.__dict__)
        out.params = dict(params)
        return out


# ----------------------------------------------------------------- camera

def view_transform(frm, to, up):
    """transformations.rs:122-134 over tensors: world -> camera."""
    def norm(v):
        return v / torch.sqrt((v * v).sum())

    forward = norm(to - frm)
    left = torch.linalg.cross(forward, norm(up))
    true_up = torch.linalg.cross(left, forward)
    rot = torch.stack([left, true_up, -forward])
    top = torch.cat([rot, -(rot @ frm)[:, None]], 1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=frm.dtype,
                          device=frm.device)
    return torch.cat([top, bottom], 0)


def camera_rays(cam, *, device="cpu", dtype=torch.float32, eye=None,
                pixels=None):
    """Primary rays through pixel centres (camera.rs:45-64), in row-major
    pixel order or for the flat pixel ids ``pixels``, computed in ``dtype``
    as the Rust code computes them in f32. ``eye``: a tensor that replaces
    ``cam["from"]`` (gradients flow to it)."""
    dev = torch.device(device)

    def vec(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    frm = eye.to(dtype) if eye is not None else vec(cam["from"])
    view = view_transform(frm, vec(cam["to"]), vec(cam["up"]))
    # torch inverts in float32 at the least
    inv = torch.linalg.inv(view.float()).to(dtype)
    h, v, fov = int(cam["hsize"]), int(cam["vsize"]), float(cam["fov"])
    half_view = math.tan(fov / 2.0)
    aspect = h / v
    half_w = half_view if aspect >= 1.0 else half_view * aspect
    half_h = half_view / aspect if aspect >= 1.0 else half_view
    psize = half_w * 2.0 / h
    if pixels is None:
        pixels = torch.arange(h * v, device=dev)
    px = (pixels % h).to(dtype)
    py = (pixels // h).to(dtype)
    wx = half_w - (px + 0.5) * psize
    wy = half_h - (py + 0.5) * psize
    pw = (wx[:, None] * inv[:3, 0] + wy[:, None] * inv[:3, 1]
          - inv[:3, 2] + inv[:3, 3])
    origin = inv[:3, 3]
    d = pw - origin
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    o = origin.expand(d.shape)
    return o.to(dtype), d.to(dtype)


# ------------------------------------------------------------- primitives

def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(v):
    return v / torch.sqrt(_dot(v, v)).clamp_min(1e-30)[..., None]


def _apply(m, x, point):
    """m [..., 4, 4] applied to x [..., 3] as a point or a vector."""
    out = (m[..., :3, :3] @ x[..., None])[..., 0]
    return out + m[..., :3, 3] if point else out


def _sphere(o, d):
    a = _dot(d, d)
    b = 2.0 * _dot(d, o)
    c = _dot(o, o) - 1.0
    disc = b * b - 4.0 * a * c
    ok = disc >= 0
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)).clamp_min(
        1e-10))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    return [torch.where(ok, t1, INF), torch.where(ok, t2, INF)]


def _plane(o, d):
    ok = d[:, 1].abs() >= EPSILON
    safe = torch.where(ok, d[:, 1], torch.ones_like(d[:, 1]))
    return [torch.where(ok, -o[:, 1] / safe, INF)]


def _axis(o, d, lo, hi):
    ok = d.abs() >= EPSILON
    safe = torch.where(ok, d, torch.ones_like(d))
    tmin_n, tmax_n = lo - o, hi - o
    inf = torch.full_like(o, INF)
    tmin = torch.where(ok, tmin_n / safe, torch.where(tmin_n >= 0, inf, -inf))
    tmax = torch.where(ok, tmax_n / safe, torch.where(tmax_n >= 0, inf, -inf))
    return torch.minimum(tmin, tmax), torch.maximum(tmin, tmax)


def _cube(o, d):
    lims = [_axis(o[:, i], d[:, i], -1.0, 1.0) for i in range(3)]
    tmin = torch.maximum(torch.maximum(lims[0][0], lims[1][0]), lims[2][0])
    tmax = torch.minimum(torch.minimum(lims[0][1], lims[1][1]), lims[2][1])
    ok = tmin <= tmax
    return [torch.where(ok, tmin, INF), torch.where(ok, tmax, INF)]


def _cylinder(o, d, mn, mx, closed):
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    a = dx * dx + dz * dz
    par = a.abs() < EPSILON
    b = 2.0 * (ox * dx + oz * dz)
    c = ox * ox + oz * oz - 1.0
    disc = b * b - 4.0 * a * c
    ok = ~par & (disc >= 0)
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)).clamp_min(
        1e-10))
    den = torch.where(par, torch.ones_like(a), 2.0 * a)
    out = []
    for t in ((-b - sq) / den, (-b + sq) / den):
        y = oy + t * dy
        out.append(torch.where(ok & (mn < y) & (y < mx), t, INF))
    cap_ok = dy.abs() >= EPSILON
    safe = torch.where(cap_ok, dy, torch.ones_like(dy))
    for lim in (mn, mx):
        t = (lim - oy) / safe
        x, z = ox + t * dx, oz + t * dz
        hit = closed & cap_ok & (x * x + z * z <= 1.0 + 1e-5)
        out.append(torch.where(hit, t, INF))
    return out


def quadric_ts(sc, o, d):
    """Every quadric's intersections: (ts [R, C], the object of each
    column [C])."""
    cols, objs = [], []
    for q, kind in enumerate(sc.q_kind):
        inv = sc.q_inv[q]
        ol, dl = _apply(inv, o, True), _apply(inv, d, False)
        if kind == 0:
            ts = _sphere(ol, dl)
        elif kind == 1:
            ts = _plane(ol, dl)
        elif kind == 2:
            ts = _cube(ol, dl)
        else:
            ts = _cylinder(ol, dl, sc.q_min[q], sc.q_max[q], sc.q_closed[q])
        cols += ts
        objs += [q] * len(ts)
    if not cols:
        return o.new_full((o.shape[0], 1), INF), [-1]
    return torch.stack(cols, -1), objs


def split_groups(centroids, size=GROUP):
    """Triangle ids [G, size] in groups of at most ``size``: the ids split
    at their median along the longest axis of their centroids, again and
    again; a smaller group repeats its first id."""
    out = []

    def split(ids):
        if len(ids) <= size:
            out.append(np.concatenate([ids, np.full(size - len(ids), ids[0])]))
            return
        c = centroids[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        ids = ids[np.argsort(c[:, axis], kind="stable")]
        split(ids[:len(ids) // 2])
        split(ids[len(ids) // 2:])

    split(np.arange(len(centroids)))
    return np.stack(out)


def _moller_trumbore(o, d, p1, e1, e2, eps):
    """o, d [M, 3] against their own triangles p1, e1, e2 [M, K, 3] -> t
    [M, K] (inf on a miss); computed component by component."""
    ox, oy, oz = (x[:, None] for x in o.unbind(-1))
    dx, dy, dz = (x[:, None] for x in d.unbind(-1))
    ax, ay, az = e1.unbind(-1)
    bx, by, bz = e2.unbind(-1)
    cx, cy, cz = dy * bz - dz * by, dz * bx - dx * bz, dx * by - dy * bx
    det = ax * cx + ay * cy + az * cz
    ok = det.abs() >= eps
    f = 1.0 / torch.where(ok, det, torch.ones_like(det))
    px, py, pz = ox - p1[..., 0], oy - p1[..., 1], oz - p1[..., 2]
    u = f * (px * cx + py * cy + pz * cz)
    qx, qy, qz = py * az - pz * ay, pz * ax - px * az, px * ay - py * ax
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (bx * qx + by * qy + bz * qz)
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    return torch.where(ok, t, INF)


def _slab(lo, hi, o, inv_d):
    """Entry and exit t of rays o, inv_d [..., 3] through boxes lo, hi."""
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)


def mesh_nearest(sc, o, d, cap):
    """The nearest triangle hit with 0 < t < cap: every triangle of every
    group whose box the ray meets before its best t so far, in the
    instances whose box it meets. No gradient. Returns (t [R] (inf:
    none), instance [R], triangle [R])."""
    r = o.shape[0]
    best = cap.detach().clone()
    inst = torch.full((r,), -1, dtype=torch.long, device=o.device)
    tri = torch.zeros((r,), dtype=torch.long, device=o.device)
    if not sc.n_inst or r == 0:
        return torch.full_like(best, INF), inst, tri
    with torch.no_grad():
        o, d = o.detach(), d.detach()
        safe = torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
        inv_d = 1.0 / safe
        for i in range(sc.n_inst):
            tn, tf = _slab(sc.inst_box[i, 0], sc.inst_box[i, 1], o, inv_d)
            rows = torch.nonzero((tn <= tf) & (tf >= 0) & (tn < best))[:, 0]
            for blk in rows.split(BOX_BLOCK):
                tn, tf = _slab(sc.grp_box[i, :, 0], sc.grp_box[i, :, 1],
                               o[blk, None], inv_d[blk, None])
                ray, grp = torch.nonzero(
                    (tn <= tf) & (tf >= 0) & (tn < best[blk, None]),
                    as_tuple=True)
                for s in range(0, ray.numel(), PAIR_BLOCK):
                    rr = blk[ray[s:s + PAIR_BLOCK]]
                    ids = sc.grp_tri[i, grp[s:s + PAIR_BLOCK]]
                    t = _moller_trumbore(
                        o[rr], d[rr], sc.tri_p1[i, ids], sc.tri_e1[i, ids],
                        sc.tri_e2[i, ids], sc.tri_eps[i])
                    tmin, k = torch.where(t > 0, t, INF).min(1)
                    k = ids.gather(1, k[:, None])[:, 0]
                    near = best.scatter_reduce(0, rr, tmin, "amin")
                    better = near < best
                    win = (tmin == near[rr]) & better[rr]
                    first = torch.full_like(
                        tri, sc.tri_p1.shape[1]).scatter_reduce(
                        0, rr[win], k[win], "amin")
                    best = torch.where(better, near, best)
                    inst = torch.where(better, i, inst)
                    tri = torch.where(better, first, tri)
    found = inst >= 0
    return torch.where(found, best, INF), inst, tri


def _winner(sc, o, d, inst, tri):
    """t, u, v of each ray's winning triangle, recomputed with gradients
    to the rays, and its three vertex normals."""
    i, k = inst.clamp_min(0), tri
    p1, e1, e2 = sc.tri_p1[i, k], sc.tri_e1[i, k], sc.tri_e2[i, k]
    c = torch.linalg.cross(d, e2)
    det = _dot(e1, c)
    f = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    p = o - p1
    u = f * _dot(p, c)
    q = torch.linalg.cross(p, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    return t, u, v, (sc.tri_n1[i, k], sc.tri_n2[i, k], sc.tri_n3[i, k])


# ---------------------------------------------------------------- shading

def _quadric_normal(sc, q, point):
    inv = sc.q_inv[q]
    lp = _apply(inv, point, True)
    lx, ly, lz = lp.unbind(-1)
    zero = torch.zeros_like(lx)
    kind = sc.q_kind_t[q]
    up = torch.stack([zero, zero + 1, zero], -1)
    cube = torch.stack([zero, zero, lz], -1)
    m = torch.maximum(torch.maximum(lx.abs(), ly.abs()), lz.abs())
    cube = torch.where((ly.abs() == m)[:, None],
                       torch.stack([zero, ly, zero], -1), cube)
    cube = torch.where((lx.abs() == m)[:, None],
                       torch.stack([lx, zero, zero], -1), cube)
    side = torch.stack([lx, zero, lz], -1)
    dist = lx * lx + lz * lz
    top = (dist < 1) & (ly >= sc.q_max[q] - EPSILON)
    bot = (dist < 1) & (ly <= sc.q_min[q] + EPSILON)
    cyl = torch.where(top[:, None], up, side)
    cyl = torch.where(bot[:, None], -up, cyl)
    local = torch.where((kind == 1)[:, None], up, lp)
    local = torch.where((kind == 2)[:, None], cube, local)
    local = torch.where((kind == 3)[:, None], cyl, local)
    world = (sc.q_nmat[q] @ local[..., None])[..., 0]
    return _normalize(world)


def _checker(sc, pat, q, point):
    obj = _apply(sc.q_inv[q], point, True)
    p = _apply(sc.pat_inv[pat], obj, True)
    s = torch.floor(p).sum(-1)
    even = torch.remainder(s, 2.0) == 0
    a, b = sc.params["pat_a"][pat], sc.params["pat_b"][pat]
    return torch.where(even[:, None], a, b)


def _n1_n2(sc, ts, objs, slot, ri_obj):
    """The container walk (intersections.rs:141-160) over every
    intersection of each ray, in order of t (ties in column order), up to
    the hit at column ``slot``: (n1, n2)."""
    r, c = ts.shape
    dev = ts.device
    n_obj = sc.n_quad
    valid = torch.isfinite(ts.detach())
    order = torch.argsort(torch.where(valid, ts.detach(), INF), dim=-1,
                          stable=True)
    objs_t = torch.as_tensor(objs, dtype=torch.long, device=dev)
    inside = torch.zeros((r, n_obj), dtype=torch.bool, device=dev)
    entered = torch.zeros((r, n_obj), dtype=torch.long, device=dev)
    one = torch.ones((r,), dtype=ri_obj.dtype, device=dev)
    n1, n2 = one, one
    done = torch.zeros((r,), dtype=torch.bool, device=dev)
    rows = torch.arange(r, device=dev)

    def last():
        key = torch.where(inside, entered, -1)
        k, j = key.max(-1)
        return torch.where(k >= 0, ri_obj[rows, j.clamp_min(0)], one)

    for step in range(c):
        col = order[:, step]
        ok = valid[rows, col] & ~done
        is_hit = ok & (col == slot)
        n1 = torch.where(is_hit, last(), n1)
        obj = objs_t[col]
        was = inside[rows, obj]
        inside[rows, obj] = torch.where(ok, ~was, was)
        entered[rows, obj] = torch.where(ok & ~was, step, entered[rows, obj])
        n2 = torch.where(is_hit, last(), n2)
        done = done | is_hit
    return n1, n2


def _shadowed(sc, over, lpos):
    """world.rs:101-111 for a batch of over points and one light."""
    v = lpos[None] - over
    dist = torch.sqrt(_dot(v, v))
    direction = v / dist[:, None]
    ts, objs = quadric_ts(sc, over, direction)
    masked = torch.where(ts > 0, ts, INF)
    t_s, col = masked.min(-1)
    objs_t = torch.as_tensor(objs, dtype=torch.long, device=over.device)
    flag = sc.obj_shadow[objs_t[col].clamp_min(0)]
    if sc.n_inst:
        t_m, inst, _ = mesh_nearest(sc, over, direction,
                                    torch.minimum(t_s, dist))
        better = t_m < t_s
        flag = torch.where(better, sc.obj_shadow[sc.n_quad
                                                 + inst.clamp_min(0)], flag)
        t_s = torch.minimum(t_m, t_s)
    return torch.isfinite(t_s) & (t_s < dist) & flag


def shade(sc, o, d, w):
    """One level: the weighted surface colours [R, 3] and the spawned
    (origin, direction, weight) of the reflected and the refracted rays."""
    p = sc.params
    ts, objs = quadric_ts(sc, o, d)
    masked = torch.where(ts > 0, ts, INF)
    t_q, slot = masked.detach().min(-1)
    t_q = torch.gather(masked, 1, slot[:, None])[:, 0]
    objs_t = torch.as_tensor(objs, dtype=torch.long, device=o.device)
    obj = objs_t[slot]
    t = t_q
    rows = None
    if sc.n_inst:
        t_m, inst, tri = mesh_nearest(sc, o, d, t_q.detach())
        rows = torch.nonzero(torch.isfinite(t_m))[:, 0]
        if rows.numel():
            # only the rays that end on a triangle: another row's stand-in
            # triangle could put an infinite term into the backward
            t_w, u, v, (n1v, n2v, n3v) = _winner(
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
        normalv = _quadric_normal(sc, q, point)
    else:
        normalv = torch.zeros_like(point)
    if rows is not None and rows.numel():
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
        chk = _checker(sc, pat.clamp_min(0), q, over)
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
        blocked = _shadowed(sc, over.detach(), lpos.detach())
        surface = surface + ambient + torch.where(blocked[:, None], 0.0, ds)
    surface = torch.where(has[:, None], surface, 0.0)

    reflective, transparency = col("reflective"), col("transparency")
    if sc.all_ri_one or not bool((transparency.detach() > 0).any()):
        n1 = n2 = torch.ones_like(t)
    else:
        ri_obj = p["mat.refractive_index"][sc.obj_mat[:sc.n_quad]]
        n1, n2 = _n1_n2(sc, ts, objs, slot,
                        ri_obj[None].expand(o.shape[0], -1))
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
    """Colours [R, 3] of the rays: every level of the bounce tree up to
    the scene's recursion limit, live rays only."""
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


def quantize_u8(c):
    """floor(clip(x, 0, 1) * 255 + 0.5) as uint8."""
    return torch.floor(c.float().clamp(0.0, 1.0) * 255.0 + 0.5).to(
        torch.uint8)


def render_u8(sc):
    """The scene's frame [vsize, hsize, 3] uint8 (numpy), in blocks of
    RAY_BLOCK rays."""
    cam = sc.desc["camera"]
    h, v = int(cam["hsize"]), int(cam["vsize"])
    out = []
    with torch.no_grad():
        for start in range(0, h * v, RAY_BLOCK):
            pix = torch.arange(start, min(start + RAY_BLOCK, h * v),
                               device=sc.device)
            o, d = camera_rays(cam, device=sc.device, dtype=sc.dtype,
                               pixels=pix)
            out.append(quantize_u8(trace(sc, o, d)).cpu())
    return torch.cat(out).numpy().reshape(v, h, 3)
