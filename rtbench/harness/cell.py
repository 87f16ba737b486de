"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), and the check of what the window produced against the
reference, once the program's state is freed."""

from __future__ import annotations

import importlib
import sys
import tempfile
import time
from pathlib import Path

from rtbench.harness import common, port

GIB = 2 ** 30


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else None


def execute(workload, seed, seconds, traced, *, t0, root=common.ROOT,
            device=None):
    """Runs the cell ``workload`` once. ``device``: None to look for the
    card (and refuse without one); a torch device to run there without
    looking (the tests run the CPU so, at sizes of their own). Returns the
    result line; raises common.Refused where there is none."""
    bench = common.load_json(root / "BENCHMARK.json")
    cell, cfg, cfg_mod, traffic = common.find_cell(bench, workload, root)
    limits = common.load_json(root / "rtbench" / "checks" / f"{workload}.json")
    loop = importlib.import_module(f"rtbench.loops.{traffic['loop']}")
    readers = {m["name"]: common.load_module(
        root / "rtbench" / "metrics" / f"{m['name']}.py")
        for m in common.metrics_of(bench, workload, "per_layer")} \
        if traced else {}
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise common.Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise common.Refused(
                f"the cell asks for {cell['chips']} cards, "
                f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
    try:
        import raytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        raise common.Refused(f"the program is not here: {e}") from e

    with tempfile.TemporaryDirectory(prefix="rtbench-") as work:
        run = loop.Cell(cfg, cfg_mod, traffic, seed, Path(work), device)
        run.setup()
        port.sync(device)
        setup_s = time.perf_counter() - t0
        e2e, attempted, failed = run.window(seconds)
        peak = port.peak_bytes(device)
        layer = breakdown = None
        if traced:
            layer, breakdown = run.trace()
        run.release()
        checks = run.check(limits)
    found = common.forbidden_modules()
    if found:
        raise common.Refused(f"modules that no run may load: {found}")

    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=cell["chips"], memory_peak_bytes=peak)
    metrics = {}
    if traced:
        prof = layer["profile"]
        dev["busy_s"] = sum(k["us"] for k in prof["kernels"].values()) / 1e6
        dev["window_s"] = prof["wall_s"]
        for m in common.metrics_of(bench, workload, "per_layer"):
            value = readers[m["name"]].read(layer)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = dict(e2e, setup_s=setup_s, peak_mem_GiB=peak / GIB)
        for m in common.metrics_of(bench, workload, "end_to_end"):
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    correct = all(c["ok"] for c in checks.values())
    limit = power_limit() if device.type == "cuda" else None
    print(f"card: {limit}; setup_s {setup_s!r}; attempted {attempted}",
          file=sys.stderr)
    for line in common.checks_text(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return common.result_line(
        correct=correct, attempted=attempted, failed=failed, metrics=metrics,
        device=dev, checks=checks, breakdown=breakdown,
        extra=dict(seed=seed, card=limit))
