"""The readings that the limits of a cell checked against the CSG and
area-light reference (``loops/area_frame.py``, ``reference/csg_area.py``)
are set from, at the cell's own size on the card, as ``control_walk.py``
gives them for the walk reference: for each seed, the program's
``px_off_hard`` and ``block_gap`` against the reference (the lower
readings), the control's (the reference computed in bfloat16, with a
jitter stream of its own, put in the program's place) and, with
``--faults``, the program's with a fault planted:

* "csg_union": a CSG difference filtered as a union (the csg_area tree's
  one difference is its root), so the cylinders are added to the solid
  where they should carve it; ``px_off_hard`` must catch it;
* "one_sample": each area light sampled once, at its centre, for its
  intensity and its lighting, so the shadows are hard and the highlights
  those of a point light; ``block_gap`` must catch it.

    python3 rtbench/control_area.py --workload csg_area.frame --seeds 1 2 3
        [--seconds 5] [--faults] [--no-control]

One JSON line a seed and reading on standard output. The benchmark's
runs never run this; ``rtbench/tests/test_rtbench_csg_area.py`` keeps the
control and the faults at a CPU size."""

import argparse
import contextlib
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAULTS = ("csg_union", "one_sample")


def _union_for_difference():
    """``core.csg._op_allowed`` with the difference's rule replaced by the
    union's: (module, name, saved, planted)."""
    from raytracer_tpu_torch.core import csg
    from raytracer_tpu_torch.core import types as T

    saved = csg._op_allowed

    def allowed(op_code, l_hit, in_l, in_r):
        if op_code == T.CSG_DIFFERENCE:
            op_code = T.CSG_UNION
        return saved(op_code, l_hit, in_l, in_r)

    return csg, "_op_allowed", saved, allowed


def _centre_sample():
    """``core.render._area_light_contrib`` with one sample at the light's
    centre in place of S jittered ones: (module, name, saved, planted)."""
    from raytracer_tpu_torch.core import intersect, render, shading
    from raytracer_tpu_torch.core import types as T

    saved = render._area_light_contrib

    def centre(scene, ai, over, eyev, normalv, base_color, mat_rows, jitter,
               live=None, jitter_phase=0):
        us, vs = scene.static.area_steps[ai]
        pos = (scene.alight_corner[ai] + us / 2 * scene.alight_uvec[ai]
               + vs / 2 * scene.alight_vvec[ai])
        intensity = scene.alight_intensity[ai]
        sh = intersect.shadow_blocked(
            scene, over, pos.expand(over.shape[0], 1, 3), live=live)[:, 0]
        ds = shading.phong(mat_rows, base_color, intensity[None], pos[None],
                           over, eyev, normalv)
        ambient = base_color * intensity[None] * render.scene_mat_col(
            mat_rows, T.MAT_AMBIENT)
        return ambient + ds * (~sh).to(ds.dtype)[:, None]

    return render, "_area_light_contrib", saved, centre


@contextlib.contextmanager
def planted(fault):
    """The program with ``fault`` planted (:data:`FAULTS`); None, the
    program as it is. Plant it before the scene's first frame: a tile
    program keeps what its capture ran."""
    if fault is None:
        yield
        return
    makers = {"csg_union": _union_for_difference,
              "one_sample": _centre_sample}
    if fault not in makers:
        raise ValueError(f"no fault {fault!r}; known: {FAULTS}")
    module, name, saved, fn = makers[fault]()
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def readings(workload, seed, seconds, faults, control, device):
    """The readings of one seed, each a dict, as they come."""
    import torch

    from rtbench.harness import common, port
    from rtbench.loops import area_frame as A

    bench = common.load_json(ROOT / "BENCHMARK.json")
    _, cfg, cfg_mod, traffic = common.find_cell(bench, workload, ROOT)
    loop = importlib.import_module(f"rtbench.loops.{traffic['loop']}")
    ref = band = ref_s = None
    for fault in (None,) + (FAULTS if faults else ()):
        with tempfile.TemporaryDirectory() as work, planted(fault):
            run = loop.Cell(cfg, cfg_mod, traffic, seed, Path(work), device)
            t = time.perf_counter()
            run.setup()
            run.window(seconds)
            setup_window = time.perf_counter() - t
            run.release()
        if ref is None:
            t = time.perf_counter()
            ref = A.reference_frame(run.desc, seed, device)
            band = A.noise_band(run.desc, device)
            ref_s = time.perf_counter() - t
        frames = {f.tobytes(): f for f in run.frames}.values()
        yield dict(reading=fault or "program",
                   px_off_hard=max(A.px_off_hard(f, ref, band)
                                   for f in frames),
                   block_gap=max(A.block_gap(f, ref) for f in frames),
                   frames=len(run.frames), band=float(band.mean()),
                   ref_s=ref_s, setup_window_s=setup_window)
        desc = run.desc
        del run
        port.free(device)
    if control:
        t = time.perf_counter()
        low = A.reference_frame(desc, seed + 1, device, torch.bfloat16)
        yield dict(reading="control", px_off_hard=A.px_off_hard(low, ref,
                                                                band),
                   block_gap=A.block_gap(low, ref),
                   ref_s=time.perf_counter() - t)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control_area: no card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        for r in readings(args.workload, seed, args.seconds, args.faults,
                          not args.no_control, device):
            print(json.dumps(dict(workload=args.workload, seed=seed, **r)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
