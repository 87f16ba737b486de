"""Examples of the library API of raytracer_tpu_torch.

``basic_scene``, ``csg`` and ``hexagon`` mirror the reference's
examples/*.rs and the JAX package's examples/*.py: each renders its scene
and prints a P3 PPM to standard output, on ``cuda`` unless ``--device
cpu``, at ``RAYTRACER_EXAMPLE_SIZE=WxH`` (default 1280x720).
``inverse_render`` descends an image loss through the renderer.
"""

import argparse
import math
import os
import sys


def example_camera(look_at):
    """The examples' camera: 60 degrees, from (0, 1.5, -5) towards
    ``look_at``, at ``RAYTRACER_EXAMPLE_SIZE`` (default 1280x720)."""
    from raytracer_tpu_torch import Camera, transforms as tf

    w, h = map(int, os.environ.get("RAYTRACER_EXAMPLE_SIZE",
                                   "1280x720").split("x"))
    return Camera(w, h, math.pi / 3).with_transform(
        tf.view_transform((0.0, 1.5, -5.0), look_at, (0.0, 1.0, 0.0)))


def print_ppm(items, look_at, doc, argv=None):
    """An example's ``main``: parse ``--device``, build ``items``, render
    them through :func:`example_camera` and print the P3 PPM."""
    from raytracer_tpu_torch import Canvas
    from raytracer_tpu_torch.core.render import render
    from raytracer_tpu_torch.scene import build_scene

    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    camera = example_camera(look_at)
    img = render(build_scene(items, device=args.device), camera)
    Canvas(camera.hsize, camera.vsize, img).to_ppm(sys.stdout)
