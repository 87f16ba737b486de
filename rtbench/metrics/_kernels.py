"""The hand-written kernels as the profiler names them, and the sums of
their device time and events: a frozen copy of chip_smoke.py's
``PROFILED_KERNELS``, ``HAND_KERNELS`` and ``device_totals``, so that a
later edit of the smoke test cannot move this yardstick.

A profile here is the plain summary that ``harness/trace.py`` makes of a
``torch.profiler`` run: ``{"units": frames or steps profiled, "wall_s",
"kernels": {name: {"us": self device microseconds, "count": events}},
"counters": launch counters' deltas over the same units}``."""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# K1's and K1b's kernels, and the launch counters
# (ops/mesh_cuda.launch_counts) that count them
PROFILED_KERNELS = {"mesh_walk_kernel<false>": ("nearest", "behind"),
                    "mesh_walk_kernel<true>": ("any_hit",),
                    "live_supergroups_kernel": ("prepass",)}
# every hand-written kernel as the profiler names it (a name holding the
# string)
HAND_KERNELS = ("table_gather_kernel", "table_gather_grad_kernel",
                "table_gather_scale_kernel",
                "table_gather_add_kernel", "table_gather_finish_kernel",
                "live_supergroups_kernel", "mesh_walk_kernel<false>",
                "mesh_walk_kernel<true>", "mesh_finish_kernel",
                "level_control_kernel", "backward_control_kernel")
K1_KERNELS = ("mesh_walk_kernel<false>", "mesh_walk_kernel<true>",
              "mesh_finish_kernel", "live_supergroups_kernel")
GATHER_KERNELS = HAND_KERNELS[:5]


def kernel_sum(profile, names):
    """(device microseconds, events) of the kernels whose name holds one
    of ``names``."""
    us = count = 0
    for key, k in profile["kernels"].items():
        if any(n in key for n in names):
            us += k["us"]
            count += k["count"]
    return us, count


def device_totals(profile):
    """Each hand-written kernel's device time (ms) and events, by name."""
    out = {}
    for name in HAND_KERNELS:
        us, count = kernel_sum(profile, (name,))
        out[name] = dict(ms=us / 1e3, launches=count)
    return out


def busy_us(profile):
    return sum(k["us"] for k in profile["kernels"].values())


def events(profile):
    return sum(k["count"] for k in profile["kernels"].values())


def counted_k1(profile):
    """Whether the profiler's K1 and K1b events equal the launch
    counters' deltas over the same units (graphed: counted from the level
    logs)."""
    counters = profile["counters"]
    for name, keys in PROFILED_KERNELS.items():
        if kernel_sum(profile, (name,))[1] != sum(counters[k] for k in keys):
            return False
    return True
