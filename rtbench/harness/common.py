"""What every run shares: finding a cell's files by name, the statistics
of the end-to-end metrics, the checks beside their limits, and the
result line."""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "rtbench"
# modules that no run may hold once its window has closed, by top-level
# name: the JAX package the program was ported from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


class Refused(Exception):
    """A run that cannot give a result; the message says why."""


def load_json(path):
    return json.loads(Path(path).read_text())


def load_module(path):
    """The Python file ``path`` as a module (its name may hold dots)."""
    path = Path(path)
    name = "rtbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise Refused(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench, workload, root=ROOT):
    """(cell, configuration file, its module, traffic file) of the
    workload ``workload`` in ``bench`` (BENCHMARK.json)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json; "
                      f"known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg_file = root / cfg_entry["file"]
    cfg = load_json(cfg_file)
    cfg_mod = load_module(cfg_file.with_suffix(".py"))
    traffic = load_json(root / "rtbench" / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, cfg_mod, traffic


def metrics_of(bench, workload, section):
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    workload reports."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def window_rate(window_s, units):
    """Seconds a unit over the whole window: its time over the frames or
    steps it completed."""
    if units <= 0:
        raise ValueError("the window completed nothing")
    return window_s / units


def spread(values):
    """The distance between the first and the third quartile
    (statistics.quantiles, n=4), as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is forbidden, compared
    whole (``raytracer_tpu_torch`` is not ``raytracer_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules
                   if name.split(".")[0] in FORBIDDEN})


def checks_text(checks):
    """One line a compared number: its name, value and limit."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r}, "
            f"{'ok' if c['ok'] else 'FAILED'})" for name, c in checks.items()]


def result_line(*, correct, attempted, failed, metrics, device, checks,
                breakdown=None, extra=None):
    """The JSON result line; the checks come last."""
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    if extra:
        out.update(extra)
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return json.dumps(out)


def check(value, limit):
    """A compared number beside its limit: within it when ``value`` is at
    most ``limit``; a number that is not finite never is."""
    ok = math.isfinite(value) and value <= limit
    return dict(value=float(value), limit=float(limit), ok=bool(ok))
