"""Library-API demo: the hexagon group (mirrors examples/hexagon.rs).

    python -m raytracer_tpu_torch.examples.hexagon [--device cpu] > out.ppm
"""

import math

from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.examples import print_ppm
from raytracer_tpu_torch.scene import PointLight, hexagon


def items():
    return [PointLight(position=(-10.0, 10.0, -10.0)),
            hexagon(tf.Transform().rotation_x(math.pi / 3)
                    .translation(0.0, 0.75, 0.0).matrix)]


LOOK_AT = (0.0, 1.0, 0.0)


def main(argv=None):
    print_ppm(items(), LOOK_AT, __doc__, argv)


if __name__ == "__main__":
    main()
