from raytracer_tpu_torch.scene.specs import (
    Material,
    Pattern,
    UvPatternSpec,
    PointLight,
    AreaLight,
    Sphere,
    Plane,
    Cube,
    Cylinder,
    Cone,
    Triangle,
    SmoothTriangle,
    Mesh,
    Group,
    Csg,
    hexagon,
)
from raytracer_tpu_torch.scene.builder import build_scene


def parse_scene(*args, **kwargs):
    """Lazy alias for
    :func:`raytracer_tpu_torch.scene.yaml_scene.parse_scene`."""
    from raytracer_tpu_torch.scene.yaml_scene import parse_scene as _parse

    return _parse(*args, **kwargs)
