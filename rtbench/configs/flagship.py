"""The flagship scene (flagship.json): a reflective checkered floor, two
diffuse spheres and a glass sphere that also reflects (the Schlick
blend), one point light, 1280x720. No mesh.

``describe`` makes the plain scene description from the seed,
``train_start`` the perturbed start of a training run, and ``port_scene``
builds the program's scene from a description through its scene specs.
"""

from __future__ import annotations

import numpy as np

from rtbench.harness import xf


def describe(cfg, seed):
    """The scene description (see reference/tracer.py) for ``seed``."""
    rng = np.random.default_rng(seed)
    floor = cfg["floor"]
    chk = dict(kind="checker", a=list(floor["checker"]["a"]),
               b=list(floor["checker"]["b"]), transform=np.eye(4))
    mats = [dict(floor["material"], pattern=chk)]
    shapes = [dict(kind="plane", transform=np.eye(4), material=0)]
    shift = cfg["color_shift"]
    for sph in cfg["spheres"]:
        m = dict(sph["material"])
        m["color"] = np.clip(np.asarray(m["color"], float) + rng.uniform(
            -shift, shift, 3), 0.0, 1.0).tolist()
        mats.append(m)
        shapes.append(dict(kind="sphere", transform=xf.compose(sph["ops"]),
                           material=len(mats) - 1))
    return dict(camera=dict(cfg["camera"]), lights=[dict(cfg["light"])],
                materials=mats, shapes=shapes,
                recursion_limit=cfg["recursion_limit"])


def train_start(cfg, desc, seed):
    """``desc`` with its colours, the keys of ``train_start``, the
    checker's colours and the light's intensity each scaled by a seeded
    factor: where a training run starts from."""
    from rtbench.reference.tracer import material

    spec = cfg["train_start"]
    rng = np.random.default_rng([seed, 1])
    lo, hi = spec["scale"]

    def jitter(v):
        return (np.asarray(v, float) * rng.uniform(lo, hi, np.shape(v))
                ).tolist()

    out = dict(desc)
    mats = []
    for m in desc["materials"]:
        m = material(**m)
        m["color"] = jitter(m["color"])
        for k in spec["material_keys"]:
            m[k] = jitter(m[k])
        if m["pattern"] is not None:
            m["pattern"] = dict(m["pattern"], a=jitter(m["pattern"]["a"]),
                                b=jitter(m["pattern"]["b"]))
        mats.append(m)
    out["materials"] = mats
    out["lights"] = [dict(lt, intensity=jitter(lt["intensity"]))
                     for lt in desc["lights"]]
    return out


def port_scene(cfg, desc, workdir, device):
    """(camera, scene) of the program, built from the description through
    its scene specs."""
    from raytracer_tpu_torch import transforms as tf
    from raytracer_tpu_torch.camera import Camera
    from raytracer_tpu_torch.scene import build_scene
    from raytracer_tpu_torch.scene import specs as S

    def mat(m):
        m = dict(m)
        pat = m.pop("pattern", None)
        if pat is not None:
            pat = S.Pattern("checker", a=tuple(pat["a"]), b=tuple(pat["b"]),
                            transform=np.asarray(pat["transform"],
                                                 np.float32))
        if "color" in m:
            m["color"] = tuple(m["color"])
        return S.Material(pattern=pat, **m)

    kinds = {"sphere": S.Sphere, "plane": S.Plane, "cube": S.Cube}
    items = [S.PointLight(position=tuple(lt["position"]),
                          intensity=tuple(lt["intensity"]))
             for lt in desc["lights"]]
    for s in desc["shapes"]:
        items.append(kinds[s["kind"]](
            transform=np.asarray(s["transform"], np.float32),
            material=mat(desc["materials"][s["material"]]),
            shadow=s.get("shadow", True)))
    cam = desc["camera"]
    camera = Camera(cam["hsize"], cam["vsize"], cam["fov"]).with_transform(
        tf.view_transform(cam["from"], cam["to"], cam["up"]))
    return camera, build_scene(items, recursion_limit=desc["recursion_limit"],
                               device=device)
