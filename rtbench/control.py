"""The readings that a cell's limits are set from, at the cell's own size
on the card: for each seed, the program's numbers against the reference
(the lower reading), the control's (the reference computed in bfloat16,
put in the program's place: the upper reading) and, for a training cell,
each fault that the cell can have planted in the program.

    python3 rtbench/control.py --workload <name> --seeds 1 2 3 [--seconds 5]
        [--faults] [--no-control]

One JSON line a seed and reading on standard output. The benchmark's
runs never run this; ``rtbench/tests/test_rtbench_control.py`` keeps the
control at a CPU size."""

import argparse
import contextlib
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def half_batch_step(orig):
    """A train step over the first half of its rays: the mean over the
    rest."""
    def step(scene, o, d, target, **kw):
        n = o.shape[0] // 2
        return orig(scene, o[:n], d[:n], target[:n], **kw)
    return step


def half_batch_grad(orig):
    """A pose gradient over the first half of its rays: the mean over the
    rest."""
    def grad(params, recombine, o, d, target, **kw):
        n = o.shape[0] // 2
        return orig(params, recombine, o[:n], d[:n], target[:n], **kw)
    return grad


@contextlib.contextmanager
def planted(fault):
    """The program with ``fault`` planted in its train entry points."""
    import raytracer_tpu_torch.parallel as P

    saved = P.train_step, P.render_loss_and_grad
    if fault == "half_batch":
        P.train_step = half_batch_step(saved[0])
        P.render_loss_and_grad = half_batch_grad(saved[1])
    try:
        yield
    finally:
        P.train_step, P.render_loss_and_grad = saved


def readings(workload, seed, seconds, faults, control, device):
    """The readings of one seed, each a dict, as they come."""
    import torch

    from rtbench.harness import common, port

    bench = common.load_json(ROOT / "BENCHMARK.json")
    _, cfg, cfg_mod, traffic = common.find_cell(bench, workload, ROOT)
    loop = importlib.import_module(f"rtbench.loops.{traffic['loop']}")
    framed = loop.__name__.endswith("frame")
    plants = [None] + (["half_batch"] if faults and not framed else [])
    for fault in plants:
        with tempfile.TemporaryDirectory() as work, planted(fault):
            run = loop.Cell(cfg, cfg_mod, traffic, seed, Path(work), device)
            t = time.perf_counter()
            run.setup()
            run.window(seconds)
            setup_window = time.perf_counter() - t
            run.release()
        if framed:
            from rtbench.reference import tracer

            t = time.perf_counter()
            ref = tracer.render_u8(tracer.Scene(run.desc, device=device))
            ref_s = time.perf_counter() - t
            got = max(loop.px_off(f, ref) for f in run.frames)
            yield dict(reading="program", px_off=got, frames=len(run.frames),
                       ref_s=ref_s, setup_window_s=setup_window)
            if control:
                low = tracer.render_u8(tracer.Scene(
                    run.desc, device=device, dtype=torch.bfloat16))
                yield dict(reading="control", px_off=loop.px_off(low, ref))
            continue
        t = time.perf_counter()
        ref = run.reference_run()
        ref_s = time.perf_counter() - t
        nums = run.numbers(*ref)
        yield dict(reading=fault or "program", ref_s=ref_s,
                   setup_window_s=setup_window, **nums, losses=run.losses,
                   ref_losses=ref[0],
                   grad_leaves=getattr(run, "grad_leaves", None),
                   change_leaves=getattr(run, "change_leaves", None))
        if control and fault is None:
            low = run.reference_run(dtype=torch.bfloat16)
            # the control in the program's place, against the reference
            ctl = type(run).__new__(type(run))
            ctl.__dict__.update(run.__dict__)
            if loop.__name__.endswith("pose"):
                ctl.losses, ctl.hist, ctl.moments = low
            else:
                ctl.losses, ctl.hist = low
            yield dict(reading="control", **ctl.numbers(*ref),
                       losses=ctl.losses)
        port.free(device)


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
        print("control: no card", file=sys.stderr)
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
