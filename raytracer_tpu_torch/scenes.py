"""The repo's headline scenes, rebuilt from in-repo data for the port.

Each function returns ``(items, camera)``: scene specs for
:func:`raytracer_tpu_torch.scene.build_scene` and the camera that frames
them.

* :func:`dragons_equiv` — the structure of
  ``benchmarks/gen_dragons_equiv.py`` (itself the structure of the
  reference's dragons.yaml): six slots, each a closed reflective pedestal
  cylinder with, in five of them, a transparent RI=1 bounding-box cube
  that casts no shadow, one point light, 1200x480 at fov 1.2, depth 4.
  Each slot holds a 7x2x2 grid of mesh instances.
* :func:`glass_mesh` — ``bench.py``'s glass-mesh cell: transparent RI=1.5
  instances over a plane at 640x360, depth 4.
* :func:`flagship` — ``__graft_entry__._flagship_scene`` and its camera.
* :func:`mesh_grad` — one mesh instance, a sphere and a plane (opaque or
  glass): the scene of the gradient checks through the mesh query.
* :func:`every_pattern` — a grid of spheres, one for each pattern kind,
  uv mapping and uv pattern kind (two images among them), over a plane
  with none: the scene of the pattern kernel's checks.

For the CLI path, :func:`write_obj` writes the generated mesh as the OBJ
file that the YAML scenes name (``teapot.obj``), and two YAML scene texts
drive area lights (one of 10x10 samples each):

* :data:`CSG_AREA_YAML` (:func:`csg_area_yaml`) — the CSG tree of
  ``examples/csg.py`` under ``bench.py``'s 10x10 area light, 640x360.
* :data:`SOFT_GLASS_YAML` (:func:`soft_glass_yaml`) — glass_mesh's layout
  as 56 ``teapot.obj`` groups, its point light replaced by a 10x10 area
  light 2 units on a side, centred on it; 640x360.

The mesh instance is :func:`revolved_mesh`, generated here: a closed-form
surface of revolution of exactly 6,320 smooth triangles spanning the
teapot model's raw box, so the teapot placements apply unchanged.

Random scenes for the differential fuzz: :func:`random_scene` (and its
parts :func:`random_material`, :func:`random_shape`,
:func:`random_csg_leaf`, :func:`random_csg`) draws the scenes of the JAX
package's ``tests/test_fuzz.py`` and ``benchmarks/fuzz_differential.py``
in the same numpy order, so one seed gives the same scene in both
packages; its meshes are :func:`revolved_obj_text` parsed as OBJ, in place
of the reference's teapot.obj. :func:`fuzz_camera` frames them.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.camera import Camera
from raytracer_tpu_torch.obj import parse_obj
from raytracer_tpu_torch.scene import build_scene
from raytracer_tpu_torch.scene import specs as S

# teapot.obj's raw box (z-up): x [-15, 17.17], y [-10, 10], z [0, 15.75]
TEAPOT_BOX = ((-15.0, -10.0, 0.0), (17.17, 10.0, 15.75))
MESH_RINGS, MESH_SEGMENTS = 40, 79      # 40 x 79 quads = 6,320 triangles


def revolved_mesh():
    """(p [6320,3,3], n [6320,3,3], smooth [6320]) f32: an elliptic
    surface of revolution about z, radius profile 0.35 + 0.65 sin(pi s)
    over height s in [0, 1], mapped into TEAPOT_BOX, with analytic vertex
    normals (the normalized cross product of the two tangents)."""
    (x0, y0, z0), (x1, y1, z1) = TEAPOT_BOX
    cx, ax, ay, h = (x0 + x1) / 2, (x1 - x0) / 2, (y1 - y0) / 2, z1 - z0
    s = np.linspace(0.0, 1.0, MESH_RINGS + 1)[:, None]          # [41, 1]
    th = np.linspace(0.0, 2 * np.pi, MESH_SEGMENTS + 1)[None]   # [1, 80]
    r = 0.35 + 0.65 * np.sin(np.pi * s)
    dr = 0.65 * np.pi * np.cos(np.pi * s)
    c, sn = np.cos(th), np.sin(th)
    pos = np.stack(np.broadcast_arrays(
        cx + ax * r * c, (y0 + y1) / 2 + ay * r * sn, z0 + h * s), -1)
    # d/dtheta x d/ds of (cx + ax r cos, ay r sin, h s)
    nrm = np.stack(np.broadcast_arrays(
        ay * h * r * c, ax * h * r * sn, -ax * ay * r * dr), -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)

    i, j = np.meshgrid(np.arange(MESH_RINGS), np.arange(MESH_SEGMENTS),
                       indexing="ij")
    a, b = (i, j), (i + 1, j)
    c2, d = (i + 1, j + 1), (i, j + 1)
    corners = [(a, b, c2), (a, c2, d)]

    def gather(arr):
        tris = [np.stack([arr[k] for k in tri], -2) for tri in corners]
        return np.stack(tris, 2).reshape(-1, 3, 3).astype(np.float32)

    p, n = gather(pos), gather(nrm)
    return p, n, np.ones(p.shape[0], bool)


# ---------------------------------------------------------------- dragons

# The six dragon slots of dragons.yaml: (group translate, inner transform
# ops, dragon color, bbox cube transparency/diffuse) — gen_dragons_equiv.py.
SLOTS = [
    ((0, 2, 0), [], (1, 0, 0.1), (0.6, 0.4)),
    ((2, 1, -1), [("rotate-y", 4), ("scale", 0.75)], (1, 0.5, 0.1), (0.8, 0.2)),
    ((-2, 0.75, -1), [("rotate-y", -0.4), ("scale", 0.75)], (0.9, 0.5, 0.1), (0.8, 0.2)),
    ((-4, 0, -2), [("rotate-y", -0.2), ("scale", 0.5)], (1, 0.9, 0.1), (0.9, 0.1)),
    ((4, 0, -2), [("rotate-y", 3.3), ("scale", 0.5)], (0.9, 1, 0.1), (0.9, 0.1)),
    ((0, 0.5, -4), [("rotate-y", 3.1415)], (1, 1, 1), (None, None)),
]

# Dragon bounding box after the dragons.yaml `dragon` define.
BB_MIN = (-1.068, 0.0, -0.317)
BB_MAX = (0.933, 1.385, 0.556)
GRID = (7, 2, 2)  # x, y, z instances per slot = 28
# the teapot's y-up footprint after rotate-x(-PI/2)
TEAPOT_SPAN = (32.17, 15.75, 20.0)


def teapot_instances():
    """(cx, cy, cz, scale) of the 28 instances filling a dragon's box."""
    nx, ny, nz = GRID
    cell = [(BB_MAX[i] - BB_MIN[i]) / GRID[i] for i in range(3)]
    s = min(cell[0] / TEAPOT_SPAN[0] * 0.95,
            cell[1] / TEAPOT_SPAN[1] * 0.95,
            cell[2] / TEAPOT_SPAN[2] * 0.95)
    out = []
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                cx = BB_MIN[0] + (ix + 0.5) * cell[0]
                cy = BB_MIN[1] + iy * cell[1]  # base sits at y=0
                cz = BB_MIN[2] + (iz + 0.5) * cell[2]
                out.append((cx, cy, cz, s))
    return out


def _bbox_transform():
    # raw-bbox define, then the bbox define that extends it
    return (tf.Transform().translation(1, 1, 1)
            .scaling(3.73335, 2.5845, 1.6283)
            .translation(-3.9863, -0.1217, -1.1820)
            .translation(0, 0.1217, 0)
            .scaling(0.268, 0.268, 0.268).matrix)


def dragons_equiv(instances=28, hsize=1200, vsize=480):
    """Six slots x ``instances`` (<= 28) mesh instances: 1,061,760 smooth
    triangles at the default 28."""
    if not 1 <= instances <= len(teapot_instances()):
        raise ValueError(f"instances must be in 1..28, got {instances}")
    p, n, smooth = revolved_mesh()
    pedestal = S.Material(color=(0.2, 0.2, 0.2), ambient=0.0, diffuse=0.8,
                          specular=0.0, reflective=0.2)
    items = [S.PointLight(position=(-10, 100, -100), intensity=(1, 1, 1))]
    for (tx, ty, tz), inner_ops, color, (transp, diff) in SLOTS:
        inner = tf.Transform()
        for op, val in inner_ops:
            inner = (inner.rotation_y(val) if op == "rotate-y"
                     else inner.scaling(val, val, val))
        mat = S.Material(color=color, ambient=0.1, diffuse=0.6,
                         specular=0.3, shininess=15.0)
        pots = [
            S.Group(
                transform=tf.Transform().rotation_x(-1.5707963)
                .scaling(s, s, s).translation(cx, cy, cz).matrix,
                children=[S.Mesh(p=p, n=n, smooth=smooth, material=mat)],
            )
            for cx, cy, cz, s in teapot_instances()[:instances]
        ]
        inner_children = [S.Group(children=pots)]
        if transp is not None:
            inner_children.append(S.Cube(
                transform=_bbox_transform(), shadow=False,
                material=S.Material(ambient=0.0, diffuse=diff, specular=0.0,
                                    transparency=transp,
                                    refractive_index=1.0)))
        items.append(S.Group(
            transform=tf.translation(tx, ty, tz),
            children=[
                S.Cylinder(min=-0.15, max=0.0, closed=True, material=pedestal),
                S.Group(transform=inner.matrix, children=inner_children),
            ],
        ))
    cam = Camera(hsize, vsize, 1.2).with_transform(
        tf.view_transform((0, 2.5, -10), (0, 1, 0), (0, 1, 0)))
    return items, cam


# ------------------------------------------------------------- glass mesh

def glass_mesh(instances=56, hsize=640, vsize=360):
    """``instances`` transparent (0.9, RI 1.5) mesh instances over a plane:
    353,920 smooth triangles at the default 56."""
    p, n, smooth = revolved_mesh()
    glass = S.Material(color=(0.05, 0.05, 0.08), transparency=0.9,
                       refractive_index=1.5, diffuse=0.1, ambient=0.02,
                       specular=0.9, shininess=300.0)
    items = [S.PointLight(position=(-10.0, 20.0, -10.0)),
             S.Plane(material=S.Material(specular=0.0))]
    for i in range(instances):
        items.append(S.Group(
            transform=(tf.translation(-8.0 + 2.0 * (i % 9), 0.0,
                                      3.0 + 2.5 * (i // 9))
                       @ tf.rotation_y(0.5 * i) @ tf.scaling(0.12, 0.12, 0.12)),
            children=[S.Mesh(p=p, n=n, smooth=smooth, material=glass)],
        ))
    cam = Camera(hsize, vsize, math.pi / 3).with_transform(
        tf.view_transform((0, 4.0, -12.0), (0, 1.0, 2.0), (0, 1, 0)))
    return items, cam


# --------------------------------------------------------------- flagship

def flagship(hsize=1280, vsize=720):
    """Reflective checkered floor, three spheres (one glass, reflective
    AND transparent: the Schlick-blend path), one point light."""
    floor = S.Plane(material=S.Material(
        specular=0.0, reflective=0.3,
        pattern=S.Pattern("checker", a=(1.0, 1.0, 1.0), b=(0.2, 0.2, 0.2)),
    ))
    middle = S.Sphere(
        transform=tf.translation(-0.5, 1.0, 0.5),
        material=S.Material(color=(0.1, 1.0, 0.5), diffuse=0.7, specular=0.3),
    )
    right = S.Sphere(
        transform=tf.Transform().scaling(0.5, 0.5, 0.5)
        .translation(1.5, 0.5, -0.5).matrix,
        material=S.Material(
            color=(0.1, 0.1, 0.1), transparency=0.9, refractive_index=1.5,
            reflective=0.9, diffuse=0.1, specular=1.0, shininess=300.0,
        ),
    )
    left = S.Sphere(
        transform=tf.Transform().scaling(0.33, 0.33, 0.33)
        .translation(-1.5, 0.33, -0.75).matrix,
        material=S.Material(color=(1.0, 0.8, 0.1), diffuse=0.7, specular=0.3),
    )
    light = S.PointLight(position=(-10.0, 10.0, -10.0), intensity=(1.0, 1.0, 1.0))
    cam = Camera(hsize, vsize, math.pi / 3).with_transform(
        tf.view_transform((0.0, 1.5, -5.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)))
    return [light, floor, middle, left, right], cam


# ----------------------------------------------------------- pattern scene

def every_pattern(hsize=96, vsize=64):
    """Every pattern kind (striped, gradient, ring, checker, xyz_rgb;
    texture maps in each of the three uv mappings with each of the three
    uv pattern kinds; two cube maps, one with every uv kind on its faces),
    one sphere each in a grid over a plane with no pattern, one point
    light. The first patterns have no transform, so pattern space is the
    object space of a sphere at the origin; the last two are a scaled and
    rotated striped and gradient. The two images, 7x5 and 4x3 texels of
    seeded colours, are padded to one table of 7x5."""
    rng = np.random.default_rng(5)
    images = [rng.random((5, 7, 3)).astype(np.float32),
              rng.random((3, 4, 3)).astype(np.float32)]
    uvs = [S.UvPatternSpec("checker", width=3, height=2, a=(1, 1, 1),
                           b=(0.1, 0.2, 0.3)),
           S.UvPatternSpec("align_check", main=(1, 1, 0), ul=(0, 1, 1),
                           ur=(1, 0, 0), bl=(0, 0, 1), br=(1, 0.5, 0)),
           S.UvPatternSpec("image", image=images[0])]
    warp = tf.Transform().rotation_y(0.7).scaling(0.6, 1.3, 0.9).matrix
    patterns = [S.Pattern(kind, a=(0.9, 0.3, 0.1), b=(0.1, 0.4, 0.8))
                for kind in ("striped", "gradient", "ring", "checker",
                             "xyz_rgb")]
    patterns += [S.Pattern("texture_map", mapping=m, uv_pattern=uv)
                 for m in ("spherical", "planar", "cylindrical")
                 for uv in uvs]
    patterns.append(S.Pattern(
        "cube_map", left=uvs[0], right=uvs[1], front=uvs[2],
        back=S.UvPatternSpec("image", image=images[1]), up=uvs[1],
        down=uvs[0]))
    patterns.append(S.Pattern("cube_map", **{
        f: uvs[1] for f in ("left", "right", "front", "back", "up", "down")}))
    patterns += [S.Pattern("striped", a=(1, 1, 1), b=(0, 0, 0),
                           transform=warp),
                 S.Pattern("gradient", a=(1, 0, 0), b=(0, 0, 1),
                           transform=warp)]
    items = [S.PointLight(position=(-10.0, 10.0, -10.0)),
             S.Plane(transform=tf.translation(0.0, -1.0, 0.0),
                     material=S.Material(color=(0.5, 0.5, 0.5)))]
    for i, pattern in enumerate(patterns):
        x, y = i % 6 - 2.5, i // 6
        items.append(S.Sphere(
            transform=tf.Transform().scaling(0.45, 0.45, 0.45)
            .translation(x, y - 0.5, 0.0).matrix,
            material=S.Material(pattern=pattern)))
    cam = Camera(hsize, vsize, math.pi / 3).with_transform(
        tf.view_transform((0.0, 1.0, -7.0), (0.0, 0.7, 0.0), (0.0, 1.0, 0.0)))
    return items, cam


# ---------------------------------------------------------- gradient scene

# the camera of mesh_grad, for the differentiable camera functions
GRAD_EYE, GRAD_TO, GRAD_UP = (0.0, 1.5, -5.0), (0.0, 0.8, 0.0), (0.0, 1.0, 0.0)
GRAD_FOV = math.pi / 3


def mesh_grad(glass, hsize=64, vsize=48):
    """One revolved_mesh instance (6,320 triangles) over a checkered
    plane, for gradients through the mesh query.

    ``glass=False``: the mesh reflective and opaque, beside a reflective
    sphere (all RIs 1: the nearest-hit path). ``glass=True``: the mesh at
    transparency 0.9, RI 1.5 (the behind column and the n1/n2 walk),
    behind a glass sphere of RI 1.3. Meshes that share one RI read it as
    the constant ``SceneStatic.mesh_uniform_refr``, so the mesh's own RI
    entry of ``mat`` takes no gradient; the sphere's does, and the rays it
    refracts meet the mesh at level 1."""
    p, n, smooth = revolved_mesh()
    if glass:
        mat = S.Material(color=(0.05, 0.05, 0.08), transparency=0.9,
                         refractive_index=1.5, diffuse=0.1, ambient=0.02,
                         specular=0.9, shininess=300.0)
        sphere = S.Sphere(
            transform=tf.translation(0.7, 0.6, -2.0) @ tf.scaling(0.6, 0.6, 0.6),
            material=S.Material(color=(0.1, 0.1, 0.1), transparency=0.8,
                                refractive_index=1.3, diffuse=0.1))
    else:
        mat = S.Material(color=(0.8, 0.3, 0.2), diffuse=0.7, reflective=0.3)
        sphere = S.Sphere(
            transform=tf.translation(1.8, 0.6, 1.0) @ tf.scaling(0.6, 0.6, 0.6),
            material=S.Material(color=(0.1, 0.4, 0.9), diffuse=0.7,
                                reflective=0.2))
    items = [
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Plane(material=S.Material(specular=0.0, pattern=S.Pattern(
            "checker", a=(1.0, 1.0, 1.0), b=(0.2, 0.2, 0.2)))),
        sphere,
        S.Group(transform=tf.translation(-0.3, 0.0, 0.0)
                @ tf.scaling(0.1, 0.1, 0.1) @ tf.rotation_x(-math.pi / 2),
                children=[S.Mesh(p=p, n=n, smooth=smooth, material=mat)]),
    ]
    cam = Camera(hsize, vsize, GRAD_FOV).with_transform(
        tf.view_transform(GRAD_EYE, GRAD_TO, GRAD_UP))
    return items, cam


# ------------------------------------------------------------- CLI scenes

def obj_text(p, n):
    """Smooth triangles (p, n [N,3,3] f32: corners and their normals) as
    Wavefront OBJ text: three ``v`` and three ``vn`` lines per triangle,
    then ``f a//a b//b c//c``. Each value is written with ``repr`` of its
    f32 value, so parsing it back gives the same floats."""
    lines = []
    for tri_p, tri_n in zip(np.asarray(p, np.float32),
                            np.asarray(n, np.float32)):
        lines += ["v " + " ".join(repr(float(x)) for x in c) for c in tri_p]
        lines += ["vn " + " ".join(repr(float(x)) for x in c) for c in tri_n]
    lines += [f"f {3 * i + 1}//{3 * i + 1} {3 * i + 2}//{3 * i + 2} "
              f"{3 * i + 3}//{3 * i + 3}" for i in range(len(p))]
    return "\n".join(lines) + "\n"


def write_obj(path, p, n):
    """Write :func:`obj_text` of (p, n) to ``path``."""
    with open(path, "w") as f:
        f.write(obj_text(p, n))


@functools.lru_cache(maxsize=1)
def revolved_obj_text():
    """:func:`obj_text` of :func:`revolved_mesh`: the text
    :func:`write_obj` writes as ``teapot.obj``."""
    return obj_text(*revolved_mesh()[:2])


def _camera_yaml(hsize, vsize, fov, frm, to):
    return (f"- add: camera\n  width: {hsize}\n  height: {vsize}\n"
            f"  field-of-view: {fov}\n  from: {list(frm)}\n"
            f"  to: {list(to)}\n  up: [0, 1, 0]\n")


def _area_light_yaml(corner, uvec, vvec, intensity):
    return (f"- add: area-light\n  corner: {list(corner)}\n"
            f"  uvec: {list(uvec)}\n  vvec: {list(vvec)}\n"
            f"  usteps: 10\n  vsteps: 10\n  intensity: {list(intensity)}\n")


def csg_area_yaml(hsize=640, vsize=360):
    """examples/csg.py's tree — (sphere x1.3 intersect cube rotated PI/3)
    minus the union of three radius-0.6 cylinders — lit by bench.py's
    10x10 area light (corner (-1, 2, 4), 2 x 2 units, intensity 1.5)."""
    return (
        _camera_yaml(hsize, vsize, "PI/3", (0, 1.5, -5), (0, 0, 0))
        + _area_light_yaml((-1, 2, 4), (2, 0, 0), (0, 2, 0), (1.5, 1.5, 1.5))
        + """- add: csg
  op: difference
  args:
  - kind: csg
    op: intersect
    args:
    - kind: sphere
      transform:
        - [scale, 1.3, 1.3, 1.3]
    - kind: cube
      transform:
        - [rotate-y, PI/3]
  - kind: csg
    op: union
    args:
    - kind: csg
      op: union
      args:
      - kind: cylinder
        transform:
          - [scale, 0.6, 0.6, 0.6]
          - [rotate-y, PI/3]
        material:
          color: [1, 0, 0]
      - kind: cylinder
        transform:
          - [scale, 0.6, 0.6, 0.6]
          - [rotate-x, PI/2]
          - [rotate-y, PI/3]
        material:
          color: [0, 0, 1]
    - kind: cylinder
      transform:
        - [scale, 0.6, 0.6, 0.6]
        - [rotate-z, PI/2]
        - [rotate-y, PI/3]
      material:
        color: [0, 1, 0]
""")


def soft_glass_yaml(instances=56, hsize=640, vsize=360):
    """glass_mesh's scene as YAML over ``teapot.obj`` (pass the file from
    :func:`write_obj` as ``--obj``): ``instances`` transparent groups
    over a plane, lit by a 10x10 area light of 2 x 2 units centred on
    glass_mesh's point light (-10, 20, -10)."""
    out = (_camera_yaml(hsize, vsize, "PI/3", (0, 4.0, -12.0), (0, 1.0, 2.0))
           + _area_light_yaml((-11.0, 20.0, -11.0), (2.0, 0.0, 0.0),
                              (0.0, 0.0, 2.0), (1, 1, 1))
           + "- add: plane\n  material:\n    specular: 0.0\n")
    for i in range(instances):
        out += (
            "- add: group\n  obj: teapot.obj\n  transform:\n"
            "    - [scale, 0.12, 0.12, 0.12]\n"
            f"    - [rotate-y, {0.5 * i!r}]\n"
            f"    - [translate, {-8.0 + 2.0 * (i % 9)!r}, 0.0, "
            f"{3.0 + 2.5 * (i // 9)!r}]\n"
            "  material:\n    color: [0.05, 0.05, 0.08]\n"
            "    transparency: 0.9\n    refractive-index: 1.5\n"
            "    diffuse: 0.1\n    ambient: 0.02\n    specular: 0.9\n"
            "    shininess: 300.0\n")
    return out


CSG_AREA_YAML = csg_area_yaml()
SOFT_GLASS_YAML = soft_glass_yaml()


# ------------------------------------------------------------ random scenes

def random_material(rng):
    """A random material, maybe patterned (any pattern kind, a texture map
    or a cube map), drawn as ``tests/test_fuzz.py:random_material`` draws
    it."""
    pattern = None
    kind = rng.choice([None, "striped", "gradient", "ring", "checker",
                       "xyz_rgb", "texture_map", "cube_map"])
    if kind == "texture_map":
        pattern = S.Pattern(
            "texture_map",
            mapping=str(rng.choice(["spherical", "planar", "cylindrical"])),
            uv_pattern=S.UvPatternSpec("checker", width=4, height=4,
                                       a=(1, 1, 1), b=(0, 0, 0)),
        )
    elif kind == "cube_map":
        face = S.UvPatternSpec("align_check", main=(1, 1, 0), ul=(0, 1, 1),
                               ur=(1, 0, 0), bl=(0, 0, 1), br=(1, 0.5, 0))
        pattern = S.Pattern("cube_map", **{
            f: face for f in ("left", "right", "front", "back", "up", "down")})
    elif kind is not None:
        pattern = S.Pattern(kind, a=tuple(rng.random(3)),
                            b=tuple(rng.random(3)),
                            transform=tf.scaling(*(0.5 + rng.random(3))))
    return S.Material(
        color=tuple(rng.random(3)),
        ambient=float(rng.random() * 0.3),
        diffuse=float(rng.random()),
        specular=float(rng.random()),
        shininess=float(10 + rng.random() * 300),
        # the inner draw comes first: rng.random(), then the choice
        reflective=float(rng.choice([0.0, rng.random()])),
        transparency=float(rng.choice([0.0, rng.random()])),
        refractive_index=float(1.0 + rng.random()),
        pattern=pattern,
    )


def random_shape(rng):
    """A randomly placed sphere, plane, cube, cylinder, cone or free
    triangle with a :func:`random_material` (``tests/test_fuzz.py``'s
    draw order)."""
    m = tf.Transform().scaling(*(0.3 + rng.random(3))) \
        .rotation_y(float(rng.random() * 6.28)) \
        .translation(*(rng.uniform(-3, 3, 3))).matrix
    mat = random_material(rng)
    kind = rng.integers(0, 6)
    if kind == 0:
        return S.Sphere(transform=m, material=mat)
    if kind == 1:
        return S.Plane(transform=m, material=mat, shadow=bool(rng.integers(2)))
    if kind == 2:
        return S.Cube(transform=m, material=mat)
    if kind == 3:
        return S.Cylinder(transform=m, material=mat, min=-1.0, max=1.0,
                          closed=bool(rng.integers(2)))
    if kind == 4:
        return S.Cone(transform=m, material=mat, min=-1.0, max=0.0,
                      closed=bool(rng.integers(2)))
    p = rng.uniform(-2, 2, (3, 3))
    return S.Triangle(transform=m, material=mat,
                      p1=tuple(p[0]), p2=tuple(p[1]), p3=tuple(p[2]))


def random_csg_leaf(rng):
    """A closed solid CSG leaf: sphere, cube or closed cylinder."""
    m = S.Material(color=tuple(rng.random(3)), diffuse=0.8,
                   specular=float(rng.random() * 0.5))
    t = (tf.translation(*rng.uniform(-1.2, 1.2, 3))
         @ tf.rotation_y(float(rng.random() * 6.28))
         @ tf.scaling(*rng.uniform(0.4, 1.3, 3)))
    kind = rng.integers(0, 3)
    if kind == 0:
        return S.Sphere(transform=t, material=m)
    if kind == 1:
        return S.Cube(transform=t, material=m)
    return S.Cylinder(transform=t, material=m, min=-1.0, max=1.0,
                      closed=True)


def random_csg(rng, depth=2):
    """A nested CSG tree (difference, intersect or union at each node) of
    at most ``depth`` + 1 levels."""
    op = ["difference", "intersect", "union"][int(rng.integers(0, 3))]
    left = (random_csg(rng, depth - 1) if depth > 0 and rng.random() < 0.6
            else random_csg_leaf(rng))
    right = (random_csg(rng, depth - 1) if depth > 0 and rng.random() < 0.4
             else random_csg_leaf(rng))
    return S.Csg(op=op, left=left, right=right)


def random_scene(seed, device="cuda"):
    """``benchmarks/fuzz_differential.py:random_scene(seed)`` built on
    ``device``: a point light, on seeds divisible by 3 a 3x3 area light, 3
    to 7 :func:`random_shape`, on odd seeds 1 or 2 :func:`random_csg`
    trees, and on even seeds two instances of :func:`revolved_obj_text`
    (2 x 6,320 triangles), transparent (0.85, RI 1.4) on seeds divisible
    by 4 and opaque otherwise; deterministic jitter (0.5) and depth 3."""
    rng = np.random.default_rng(seed)
    items = [S.PointLight(position=tuple(rng.uniform(-10, 10, 3)))]
    if seed % 3 == 0:
        items.append(S.AreaLight(
            corner=tuple(rng.uniform(-5, 5, 3)),
            uvec=(2.0, 0.0, 0.0), vvec=(0.0, 2.0, 0.0),
            usteps=3, vsteps=3,
        ))
    for _ in range(int(rng.integers(3, 8))):
        items.append(random_shape(rng))
    if seed % 2 == 1:
        for _ in range(int(rng.integers(1, 3))):
            items.append(random_csg(rng))
    if seed % 2 == 0:
        src = revolved_obj_text()
        mat = (S.Material(color=(0.05, 0.05, 0.1), transparency=0.85,
                          refractive_index=1.4, diffuse=0.1)
               if seed % 4 == 0 else
               S.Material(color=tuple(rng.random(3)), diffuse=0.8))
        for _ in range(2):
            g = parse_obj(src, mat)
            g.transform = (
                tf.translation(*rng.uniform(-3, 3, 3))
                @ tf.rotation_y(float(rng.random() * 6.28))
                @ tf.scaling(0.1, 0.1, 0.1)
            )
            items.append(g)
    return build_scene(items, jitter=(0.5,), recursion_limit=3,
                       device=device)


def fuzz_camera(hsize=64, vsize=48):
    """The fuzz's camera: fov pi/3 from (0, 2, -8) towards (0, 0.5, 0)."""
    return Camera(hsize, vsize, math.pi / 3).with_transform(
        tf.view_transform((0, 2.0, -8.0), (0, 0.5, 0), (0, 1, 0)))
