"""The glass scene (glass.json): 56 instances of one transparent mesh
(refractive index 1.5, a generated closed mesh at teapot.obj's size,
dragons.py's surface of revolution) in a grid over a plane, one point
light, 1280x720: the layout of ``scenes.glass_mesh``.

``describe`` makes the plain scene description from the seed (the
references read it); ``port_scene`` hands the same scene to the program
the way its command line gets it: a YAML scene file and an OBJ file,
through ``scene.yaml_scene.parse_scene``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from rtbench.harness import common, xf

# the mesh, its OBJ text and the materials' YAML come from dragons.py
DRAGONS = common.load_module(Path(__file__).with_name("dragons.py"))


def instance_ops(cfg, i):
    """The op list of instance ``i``: scaled, turned about y by
    ``rotate_y`` i, and moved to its cell of the grid."""
    g = cfg["instances"]
    row, col = divmod(i, g["columns"])
    s = g["scale"]
    return [["scale", s, s, s], ["rotate-y", g["rotate_y"] * i],
            ["translate", g["x0"] + g["dx"] * col, 0, g["z0"] + g["dz"] * row]]


def describe(cfg, seed):
    """The scene description (see reference/tracer.py) for ``seed``."""
    rng = np.random.default_rng(seed)
    obj = DRAGONS.revolved_mesh(cfg["mesh"], rng)
    shift = cfg["mesh"]["color_shift"]
    glass = dict(cfg["glass_material"])
    glass["color"] = np.clip(np.asarray(glass["color"], float) + rng.uniform(
        -shift, shift, 3), 0.0, 1.0).tolist()
    mats = [dict(cfg["plane_material"]), glass]
    shapes = [dict(kind="plane", transform=np.eye(4), material=0)]
    insts = [dict(mesh=0, transform=xf.compose(instance_ops(cfg, i)),
                  material=1) for i in range(cfg["instances"]["count"])]
    mesh = dict(p=obj["v"][obj["f"]], n=obj["vn"][obj["fn"]])
    return dict(camera=dict(cfg["camera"]), lights=[dict(cfg["light"])],
                materials=mats, shapes=shapes, meshes=[mesh],
                instances=insts, recursion_limit=cfg["recursion_limit"],
                glass=glass, obj=obj)


def scene_yaml(cfg, desc, obj_name):
    """The scene file of ``desc``: the camera, the light, the plane and a
    group an instance that reads the OBJ under its transform, in the
    glass material."""
    cam, lt = cfg["camera"], cfg["light"]
    vec = lambda v: "[" + ", ".join(xf.num(x) for x in v) + "]"  # noqa
    out = [
        "- add: camera", f"  width: {cam['hsize']}",
        f"  height: {cam['vsize']}", f"  field-of-view: {xf.num(cam['fov'])}",
        f"  from: {vec(cam['from'])}", f"  to: {vec(cam['to'])}",
        f"  up: {vec(cam['up'])}",
        "- add: point-light", f"  at: {vec(lt['position'])}",
        f"  intensity: {vec(lt['intensity'])}",
        "- add: plane", DRAGONS._material_yaml(cfg["plane_material"], 2),
    ]
    for i in range(cfg["instances"]["count"]):
        out += ["- add: group", f"  obj: {obj_name}",
                f"  transform: {xf.yaml_ops(instance_ops(cfg, i))}",
                DRAGONS._material_yaml(desc["glass"], 2)]
    return "\n".join(out) + "\n"


def port_scene(cfg, desc, workdir, device):
    """(camera, scene) of the program, from the scene file and the OBJ
    file written under ``workdir``, through the command line's parser."""
    from raytracer_tpu_torch.scene.yaml_scene import parse_scene

    obj = workdir / "glass.obj"
    obj.write_text(DRAGONS.obj_text(desc["obj"]))
    text = scene_yaml(cfg, desc, obj.name)
    return parse_scene(text, obj_files=[str(obj)],
                       recursion_limit=desc["recursion_limit"], device=device)
