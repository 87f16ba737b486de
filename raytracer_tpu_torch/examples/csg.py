"""Library-API demo: nested CSG (mirrors examples/csg.rs).

    python -m raytracer_tpu_torch.examples.csg [--device cpu] > out.ppm
"""

import math

from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.examples import print_ppm
from raytracer_tpu_torch.scene import (
    Csg, Cube, Cylinder, Material, PointLight, Sphere)

PI = math.pi


def items():
    def rod(*turns, color):
        t = tf.Transform().scaling(0.6, 0.6, 0.6)
        for axis, angle in turns:
            t = getattr(t, f"rotation_{axis}")(angle)
        return Cylinder(transform=t.rotation_y(PI / 3).matrix,
                        material=Material(color=color))

    outer = Csg(op="intersect",
                left=Sphere(transform=tf.scaling(1.3, 1.3, 1.3)),
                right=Cube(transform=tf.rotation_y(PI / 3)))
    inner = Csg(op="union",
                left=Csg(op="union", left=rod(color=(1.0, 0.0, 0.0)),
                         right=rod(("x", PI / 2), color=(0.0, 0.0, 1.0))),
                right=rod(("z", PI / 2), color=(0.0, 1.0, 0.0)))
    return [PointLight(position=(-10.0, 10.0, -10.0)),
            Csg(op="difference", left=outer, right=inner)]


LOOK_AT = (0.0, 0.0, 0.0)


def main(argv=None):
    print_ppm(items(), LOOK_AT, __doc__, argv)


if __name__ == "__main__":
    main()
