"""CLI: YAML scene in -> ASCII PPM out (the reference's main.rs).

    python -m raytracer_tpu_torch --scene scene.yaml [--obj m.obj ...]
        [--ppm tex.ppm ...] [--dithering bayer4] [--out out.ppm]
        [--tile-rays N] [--device cuda|cpu]

It renders on the card (``--device cuda``, the default) and fails when
there is none; ``--device cpu`` renders on the host with the kernels'
plain versions.
"""

from __future__ import annotations

import argparse
import sys

from raytracer_tpu_torch.scene.yaml_scene import render_scene_file

DITHER_CHOICES = ("bayer2", "bayer4", "bayer8", "bayer16", "bayer-color")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="raytracer_tpu_torch",
        description="The Ray Tracer Challenge CLI (PyTorch/CUDA)")
    parser.add_argument("--scene", required=True, metavar="FILE",
                        help="A yaml description of the scene to render")
    parser.add_argument("--obj", action="append", default=[], metavar="FILE",
                        help="Optional obj models to add to the scene")
    parser.add_argument("--ppm", action="append", default=[], metavar="FILE",
                        help="Optional ppm textures to use as material")
    parser.add_argument("--dithering", choices=DITHER_CHOICES,
                        metavar="PARAMS",
                        help="Add dithering effect to the final image")
    parser.add_argument("--out", metavar="FILE",
                        help="Optional output ppm file, defaults to stdout")
    parser.add_argument("--tile-rays", type=int, default=None,
                        help="Rays per batch (a memory/speed knob); by "
                             "default render() picks it from the scene")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where to render (default: cuda)")
    args = parser.parse_args(argv)

    canvas = render_scene_file(
        args.scene,
        obj_files=args.obj,
        ppm_files=args.ppm,
        dithering=args.dithering,
        tile_rays=args.tile_rays,
        device=args.device,
    )
    if args.out:
        with open(args.out, "wb") as f:
            canvas.to_ppm(f)
    else:
        canvas.to_ppm(sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
