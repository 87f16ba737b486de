"""The dragons scene (dragons.json): six pedestals, each with one dragon
(one generated closed mesh at dragon.obj's size, added once a slot as
dragons.yaml adds its ``dragon``) and, in five of them, a transparent
bounding-box cube that casts no shadow; one point light; 1200x480.

``describe`` makes the plain scene description from the seed (the
reference reads it); ``port_scene`` hands the same scene to the program
the way its command line gets it: a YAML scene file and an OBJ file,
through ``scene.yaml_scene.parse_scene``.
"""

from __future__ import annotations

import numpy as np

from rtbench.harness import xf


def revolved_mesh(spec, rng):
    """A closed surface of revolution about y with a seeded ripple, in
    the box ``box_min``..``box_max`` shrunk by ``fill`` about its centre:
    radius (0.35 + 0.65 sin(pi s)) (1 + a sin(k t + phi)) over height s
    in [0, 1] and angle t, each end closed by a fan of flat triangles.
    Returns the OBJ's tables: vertices [V, 3], normals [V, 3] (the
    normalised cross product of the side's tangents; the caps' axis) and
    the triangles' vertex and normal ids [N, 3], 2 (rings + 1) segments
    triangles."""
    rings, segs = spec["rings"], spec["segments"]
    lo, hi = np.asarray(spec["box_min"]), np.asarray(spec["box_max"])
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * spec["fill"]
    y0, h = mid[1] - half[1], 2 * half[1]
    amp = rng.uniform(*spec["ripple"])
    phi = rng.uniform(0.0, 2 * np.pi)
    k = spec["lobes"]
    s = np.linspace(0.0, 1.0, rings + 1)[:, None]
    th = np.linspace(0.0, 2 * np.pi, segs + 1)[None]
    base = 0.35 + 0.65 * np.sin(np.pi * s)
    dbase = 0.65 * np.pi * np.cos(np.pi * s)
    wob = 1.0 + amp * np.sin(k * th + phi)
    r, r_s, r_t = base * wob, dbase * wob, base * amp * k * np.cos(
        k * th + phi)
    c, sn = np.cos(th), np.sin(th)
    ax, az = half[0], half[2]
    pos = np.stack(np.broadcast_arrays(mid[0] + ax * r * c, y0 + h * s,
                                       mid[2] + az * r * sn), -1)
    p_t = np.stack(np.broadcast_arrays(ax * (r_t * c - r * sn), 0 * s,
                                       az * (r_t * sn + r * c)), -1)
    p_s = np.stack(np.broadcast_arrays(ax * r_s * c, h + 0 * th,
                                       az * r_s * sn), -1)
    nrm = np.cross(p_s, p_t)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    grid = np.arange((rings + 1) * (segs + 1)).reshape(rings + 1, segs + 1)
    bottom, top = grid.size, grid.size + 1
    verts = np.concatenate([pos.reshape(-1, 3), [[mid[0], y0, mid[2]],
                                                 [mid[0], y0 + h, mid[2]]]])
    norms = np.concatenate([nrm.reshape(-1, 3), [[0, -1, 0], [0, 1, 0]]])
    a, b = grid[:-1, :-1], grid[1:, :-1]
    c2, d = grid[1:, 1:], grid[:-1, 1:]
    side = np.concatenate([np.stack([a, b, c2], -1).reshape(-1, 3),
                           np.stack([a, c2, d], -1).reshape(-1, 3)])
    ring0, ring1 = grid[0], grid[-1]
    caps_v = np.concatenate([
        np.stack([np.full(segs, bottom), ring0[1:], ring0[:-1]], -1),
        np.stack([np.full(segs, top), ring1[:-1], ring1[1:]], -1)])
    caps_n = np.concatenate([np.full((segs, 3), bottom),
                             np.full((segs, 3), top)])
    return dict(v=verts.astype(np.float32), vn=norms.astype(np.float32),
                f=np.concatenate([side, caps_v]),
                fn=np.concatenate([side, caps_n]))


def _colors(cfg, rng):
    shift = cfg["mesh"]["color_shift"]
    return [np.clip(np.asarray(slot["color"], float)
                    + rng.uniform(-shift, shift, 3), 0.0, 1.0).tolist()
            for slot in cfg["slots"]]


def describe(cfg, seed):
    """The scene description (see reference/tracer.py) for ``seed``."""
    rng = np.random.default_rng(seed)
    obj = revolved_mesh(cfg["mesh"], rng)
    colors = _colors(cfg, rng)
    ped = cfg["pedestal"]
    mats = [dict(ped["material"])]
    shapes, insts = [], []
    dragon = xf.compose(cfg["dragon_ops"])
    bbox = xf.compose(cfg["bbox_ops"])
    for slot, color in zip(cfg["slots"], colors):
        group = xf.translate(*slot["translate"])
        inner = group @ xf.compose(slot["ops"])
        shapes.append(dict(kind="cylinder", transform=group, material=0,
                           min=ped["min"], max=ped["max"],
                           closed=ped["closed"]))
        mats.append(dict(cfg["dragon_material"], color=color))
        insts.append(dict(mesh=0, transform=inner @ dragon,
                          material=len(mats) - 1))
        if slot["bbox"] is not None:
            mats.append(dict(cfg["bbox_material"], **slot["bbox"]))
            shapes.append(dict(kind="cube", transform=inner @ bbox,
                               material=len(mats) - 1, shadow=False))
    mesh = dict(p=obj["v"][obj["f"]], n=obj["vn"][obj["fn"]])
    return dict(camera=dict(cfg["camera"]), lights=[dict(cfg["light"])],
                materials=mats, shapes=shapes, meshes=[mesh],
                instances=insts, recursion_limit=cfg["recursion_limit"],
                colors=colors, obj=obj)


def _material_yaml(m, indent):
    keys = ("color", "ambient", "diffuse", "specular", "shininess",
            "reflective", "transparency", "refractive_index")
    items = []
    for k in keys:
        if k in m:
            v = m[k]
            val = ("[" + ", ".join(xf.num(x) for x in v) + "]"
                   if isinstance(v, (list, tuple)) else xf.num(v))
            items.append(f"{k.replace('_', '-')}: {val}")
    return " " * indent + "material: {" + ", ".join(items) + "}"


def scene_yaml(cfg, desc, obj_name):
    """The scene file of ``desc``, in the layout of dragons.yaml: a group
    a slot holding its pedestal and a group of the slot's rotation and
    scale, which holds the dragon (a group that reads the OBJ) and the
    bounding-box cube."""
    cam, lt = cfg["camera"], cfg["light"]
    vec = lambda v: "[" + ", ".join(xf.num(x) for x in v) + "]"  # noqa
    out = [
        "- add: camera", f"  width: {cam['hsize']}",
        f"  height: {cam['vsize']}", f"  field-of-view: {xf.num(cam['fov'])}",
        f"  from: {vec(cam['from'])}", f"  to: {vec(cam['to'])}",
        f"  up: {vec(cam['up'])}",
        "- add: point-light", f"  at: {vec(lt['position'])}",
        f"  intensity: {vec(lt['intensity'])}",
    ]
    ped = cfg["pedestal"]
    for slot, color in zip(cfg["slots"], desc["colors"]):
        mat = dict(cfg["dragon_material"], color=color)
        out += ["- add: group",
                f"  transform: {xf.yaml_ops([['translate', *slot['translate']]])}",
                "  shapes:",
                "    - add: cylinder", f"      min: {xf.num(ped['min'])}",
                f"      max: {xf.num(ped['max'])}",
                f"      closed: {str(ped['closed']).lower()}",
                _material_yaml(ped["material"], 6),
                "    - add: group",
                f"      transform: {xf.yaml_ops(slot['ops'])}",
                "      shapes:",
                "        - add: group", f"          obj: {obj_name}",
                f"          transform: {xf.yaml_ops(cfg['dragon_ops'])}",
                _material_yaml(mat, 10)]
        if slot["bbox"] is not None:
            out += ["        - add: cube",
                    f"          transform: {xf.yaml_ops(cfg['bbox_ops'])}",
                    "          shadow: false",
                    _material_yaml(dict(cfg["bbox_material"], **slot["bbox"]),
                                   10)]
    return "\n".join(out) + "\n"


def obj_text(obj):
    """The mesh as OBJ text: its vertices, normals and ``f v//vn`` faces;
    each value is written with the 9 digits that give its float32 value
    back when read."""
    lines = ["v %.9g %.9g %.9g" % row for row in map(tuple, obj["v"].tolist())]
    lines += ["vn %.9g %.9g %.9g" % row
              for row in map(tuple, obj["vn"].tolist())]
    ids = np.stack([obj["f"], obj["fn"]], -1).reshape(-1, 6) + 1
    lines += ["f %d//%d %d//%d %d//%d" % row
              for row in map(tuple, ids.tolist())]
    return "\n".join(lines) + "\n"


def port_scene(cfg, desc, workdir, device):
    """(camera, scene) of the program, from the scene file and the OBJ
    file written under ``workdir``, through the command line's parser."""
    from raytracer_tpu_torch.scene.yaml_scene import parse_scene

    obj = workdir / "dragon.obj"
    obj.write_text(obj_text(desc["obj"]))
    text = scene_yaml(cfg, desc, obj.name)
    return parse_scene(text, obj_files=[str(obj)],
                       recursion_limit=desc["recursion_limit"], device=device)
