"""Runs one cell of the benchmark once and prints its result line.

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``raytracer_tpu_torch``)
and a card. With ``--trace 0`` the line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics (a few frames or steps
under torch.profiler after the window). Every run checks what its window
produced against the plain reference (``rtbench/reference``). Without a
card, without the program, or with JAX loaded, it exits with 2 and prints
no result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches live in the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    from rtbench.harness import cell, common

    try:
        line = cell.execute(args.workload, args.seed, args.seconds,
                            bool(args.trace), t0=T0, root=ROOT)
    except common.Refused as e:
        print(f"rtbench: no result: {e}", file=sys.stderr)
        return 2
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
