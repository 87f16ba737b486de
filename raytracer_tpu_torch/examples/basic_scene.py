"""Library-API demo: a hand-built world (mirrors examples/basic_scene.rs).

    python -m raytracer_tpu_torch.examples.basic_scene [--device cpu] > out.ppm
"""

import math

from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.examples import print_ppm
from raytracer_tpu_torch.scene import Material, Plane, PointLight, Sphere


def items():
    wall = Material(color=(1.0, 0.9, 0.9), specular=0.0)
    return [
        PointLight(position=(-10.0, 10.0, -10.0)),
        Plane(material=wall),
        Plane(transform=tf.Transform().rotation_x(math.pi / 2)
              .rotation_y(-math.pi / 4).translation(0.0, 0.0, 5.0).matrix,
              material=wall),
        Plane(transform=tf.Transform().rotation_x(math.pi / 2)
              .rotation_y(math.pi / 4).translation(0.0, 0.0, 5.0).matrix,
              material=wall),
        Sphere(transform=tf.translation(-0.5, 1.0, 0.5),
               material=Material(color=(0.1, 1.0, 0.5), diffuse=0.7,
                                 specular=0.3)),
        Sphere(transform=tf.Transform().scaling(0.5, 0.5, 0.5)
               .translation(1.5, 0.5, -0.5).matrix,
               material=Material(color=(0.5, 1.0, 0.1), diffuse=0.7,
                                 specular=0.3)),
        Sphere(transform=tf.Transform().scaling(0.33, 0.33, 0.33)
               .translation(-1.5, 0.33, -0.75).matrix,
               material=Material(color=(1.0, 0.8, 0.1), diffuse=0.7,
                                 specular=0.3)),
    ]


LOOK_AT = (0.0, 1.0, 0.0)


def main(argv=None):
    print_ppm(items(), LOOK_AT, __doc__, argv)


if __name__ == "__main__":
    main()
