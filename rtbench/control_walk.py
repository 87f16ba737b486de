"""The readings that the limits of a cell checked against the walk
reference (``loops/walk_frame.py``, ``reference/walk.py``) are set from,
at the cell's own size on the card, as ``control.py`` gives them for the
cells checked against ``reference/tracer.py``: for each seed, the
program's ``px_off`` against the reference (the lower reading), the
control's (the walk reference computed in bfloat16, put in the program's
place) and, with ``--faults``, the program's with a fault planted: "no
behind column", where the nearest-behind query of transparent meshes
finds no triangle, so that a ray inside glass takes n1 = 1.

    python3 rtbench/control_walk.py --workload glass.frame --seeds 1 2 3
        [--seconds 5] [--faults] [--no-control]

One JSON line a seed and reading on standard output. The benchmark's
runs never run this; ``rtbench/tests/test_rtbench_glass.py`` keeps the
control and the fault at a CPU size."""

import argparse
import contextlib
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAULTS = ("no_behind",)


@contextlib.contextmanager
def planted(fault):
    """The program with ``fault`` planted: "no_behind", the nearest-behind
    query (``core.intersect._tri_behind``) answering "none" (t = -inf) for
    every ray; None, the program as it is. Plant it before the scene's
    first frame: a tile program keeps what its capture ran."""
    if fault is None:
        yield
        return
    if fault != "no_behind":
        raise ValueError(f"no fault {fault!r}; known: {FAULTS}")
    import torch

    from raytracer_tpu_torch.core import intersect

    saved = intersect._tri_behind

    def no_entry(scene, origins, directions):
        t, gid = saved(scene, origins, directions)
        return torch.full_like(t, -float("inf")), gid

    intersect._tri_behind = no_entry
    try:
        yield
    finally:
        intersect._tri_behind = saved


def readings(workload, seed, seconds, faults, control, device):
    """The readings of one seed, each a dict, as they come."""
    import torch

    from rtbench.harness import common, port
    from rtbench.loops.frame import px_off
    from rtbench.reference import walk

    bench = common.load_json(ROOT / "BENCHMARK.json")
    _, cfg, cfg_mod, traffic = common.find_cell(bench, workload, ROOT)
    loop = importlib.import_module(f"rtbench.loops.{traffic['loop']}")
    ref = ref_s = None
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
            ref = walk.render_u8(walk.Scene(run.desc, device=device))
            ref_s = time.perf_counter() - t
        got = max(px_off(f, ref) for f in run.frames)
        yield dict(reading=fault or "program", px_off=got,
                   frames=len(run.frames), ref_s=ref_s,
                   setup_window_s=setup_window)
        desc = run.desc
        del run
        port.free(device)
    if control:
        t = time.perf_counter()
        low = walk.render_u8(walk.Scene(desc, device=device,
                                        dtype=torch.bfloat16))
        yield dict(reading="control", px_off=px_off(low, ref),
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
        print("control_walk: no card", file=sys.stderr)
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
