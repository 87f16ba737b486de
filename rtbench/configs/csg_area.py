"""The CSG scene under an area light (csg_area.json): csg.rs's carved
solid, (a sphere scaled 1.3 intersected with a cube turned pi/3 about y)
minus the union of three radius-0.6 cylinders, lit by a 10x10 area light
of 2 x 2 units, 640x360: the scene of ``scenes.csg_area_yaml``.

``describe`` makes the plain scene description from the seed (the
reference, ``reference/csg_area.py``, reads it); ``port_scene`` hands the
same scene to the program the way its command line gets it: a YAML scene
file, through ``scene.yaml_scene.parse_scene``, with random area-light
jitter.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from rtbench.harness import common, xf
from rtbench.reference.tracer import material

# the material's YAML comes from dragons.py
DRAGONS = common.load_module(Path(__file__).with_name("dragons.py"))


def describe(cfg, seed):
    """The scene description (see reference/csg_area.py) for ``seed``:
    each primitive's colour shifted by up to ``color_shift`` a channel."""
    rng = np.random.default_rng(seed)
    shift = cfg["color_shift"]
    mats, shapes = [], []
    for i, s in enumerate(cfg["shapes"]):
        color = np.clip(np.asarray(s["color"], float) + rng.uniform(
            -shift, shift, 3), 0.0, 1.0)
        mats.append(material(color=color.tolist()))
        shapes.append(dict(kind=s["kind"], ops=s["ops"],
                           transform=xf.compose(s["ops"]), material=i))
    return dict(camera=dict(cfg["camera"]), lights=[],
                area_lights=[dict(cfg["area_light"])], materials=mats,
                shapes=shapes, csg=[cfg["csg"]],
                recursion_limit=cfg["recursion_limit"])


def _child_yaml(desc, node, pad):
    """The YAML lines of a CSG child, a list item at indent ``pad``."""
    if isinstance(node, int):
        s = desc["shapes"][node]
        return [f"{pad}- kind: {s['kind']}",
                f"{pad}  transform: {xf.yaml_ops(s['ops'])}",
                DRAGONS._material_yaml(desc["materials"][s["material"]],
                                       len(pad) + 2)]
    op, left, right = node
    return ([f"{pad}- kind: csg", f"{pad}  op: {op}", f"{pad}  args:"]
            + _child_yaml(desc, left, pad + "  ")
            + _child_yaml(desc, right, pad + "  "))


def scene_yaml(cfg, desc):
    """The scene file of ``desc``: the camera, the area light and the CSG
    tree, each primitive in its own material."""
    cam, lt = cfg["camera"], cfg["area_light"]
    vec = lambda v: "[" + ", ".join(xf.num(x) for x in v) + "]"  # noqa
    out = [
        "- add: camera", f"  width: {cam['hsize']}",
        f"  height: {cam['vsize']}", f"  field-of-view: {xf.num(cam['fov'])}",
        f"  from: {vec(cam['from'])}", f"  to: {vec(cam['to'])}",
        f"  up: {vec(cam['up'])}",
        "- add: area-light", f"  corner: {vec(lt['corner'])}",
        f"  uvec: {vec(lt['uvec'])}", f"  usteps: {lt['usteps']}",
        f"  vvec: {vec(lt['vvec'])}", f"  vsteps: {lt['vsteps']}",
        f"  intensity: {vec(lt['intensity'])}",
    ]
    for op, left, right in desc["csg"]:
        out += ["- add: csg", f"  op: {op}", "  args:"]
        out += _child_yaml(desc, left, "  ") + _child_yaml(desc, right, "  ")
    return "\n".join(out) + "\n"


def port_scene(cfg, desc, workdir, device):
    """(camera, scene) of the program, from the scene file written under
    ``workdir``, through the command line's parser; the area light draws
    random jitter (render's default generator)."""
    from raytracer_tpu_torch.scene.yaml_scene import parse_scene

    path = workdir / "csg_area.yaml"
    path.write_text(scene_yaml(cfg, desc))
    return parse_scene(path.read_text(),
                       recursion_limit=desc["recursion_limit"], device=device)
