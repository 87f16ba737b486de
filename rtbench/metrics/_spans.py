"""The program's span recorder and on-card counters, for the per-layer
readers that read them.

Importing this module turns the recorder of
``raytracer_tpu_torch.utils.profiling`` on. ``harness/cell.py`` loads the
per-layer readers before set-up and only under ``--trace 1``, so a traced
run records the program's spans from set-up on and reads K1's tests
counted on the card, and a ``--trace 0`` run, which gives the end-to-end
numbers, runs with the recorder off. Where the program has no recorder, nothing is turned on
and the readers give nothing.

A span reader takes, over the root spans of its kind (``frame``; ``step``,
or ``loss_and_grad`` where no step encloses it) that are not marked
``profiled`` (torch.profiler's CUPTI slows the host's launches), the
median of the named spans' summed durations per root; a root that holds
none of them is left out."""

from __future__ import annotations

import statistics

from rtbench.metrics._kernels import PEAK_F32_FLOPS, kernel_sum

FRAME_ROOTS = ("frame",)
TRAIN_ROOTS = ("step", "loss_and_grad")
# f32 operations of one ray x triangle test (about; chip_smoke.py's
# MT_FLOPS, frozen here)
MT_FLOPS = 50
WALK_KERNELS = ("mesh_walk_kernel",)


def _recorder():
    try:
        from raytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


RECORDER = _recorder()
if RECORDER is not None:
    RECORDER.enable()


def spans():
    """The program's recorded spans (none without a recorder)."""
    return RECORDER.spans() if RECORDER is not None else []


def _roots(recorded, roots):
    return {s.sid: s for s in recorded
            if s.parent is None and s.name in roots and not s.profiled}


def per_root_ns(recorded, roots, names):
    """{request id: the summed durations (ns) of the spans named
    ``names``} over the unprofiled roots named ``roots`` that hold one."""
    keep = _roots(recorded, roots)
    out = {}
    for s in recorded:
        if s.name in names and s.rid in keep:
            out[s.rid] = out.get(s.rid, 0) + s.end - s.start
    return out


def median_ms(roots, names, recorded=None):
    """The median over roots of :func:`per_root_ns`, in ms; None where no
    root holds the spans."""
    sums = per_root_ns(spans() if recorded is None else recorded, roots,
                       names)
    return statistics.median(sums.values()) / 1e6 if sums else None


def device_ms(roots, recorded=None):
    """The median over the unprofiled roots of their ``device_ms`` (the
    card's time from a unit's first enqueued work to its last); None where
    none has it."""
    got = [s.attrs["device_ms"] for s in _roots(
        spans() if recorded is None else recorded, roots).values()
        if "device_ms" in s.attrs]
    return statistics.median(got) if got else None


def total_s(name, recorded=None):
    """The summed durations (s) of every span ``name``; None where none
    was recorded."""
    got = [s.end - s.start for s in (spans() if recorded is None
                                     else recorded) if s.name == name]
    return sum(got) / 1e9 if got else None


def k1_roofline(profile):
    """K1's walk's share of its f32 bound, in %: the tests its gates let
    through in the profiled units (counted on the card, ``k1_tests``),
    ``MT_FLOPS`` each, over the H100's f32 peak, over the walk kernels'
    device time in the same units; None where either is absent."""
    if not profile:
        return None
    tests = profile["counters"].get("k1_tests")
    us, count = kernel_sum(profile, WALK_KERNELS)
    if not tests or not count:
        return None
    return 100.0 * MT_FLOPS * tests / PEAK_F32_FLOPS / (us / 1e6)
