"""The traced stretch of a ``--trace 1`` run: a few frames or steps under
``torch.profiler``, after the unprofiled window (CUPTI stays attached to
the process once a trace has run, and slows the host's launches), reduced
to the plain profile that the metric readers take (see
``metrics/_kernels.py``) and to the breakdown of the result line."""

from __future__ import annotations

import time

# host events that the profiler records of its own work
PROFILER_EVENTS = frozenset({"Resource", "Activity Buffer Request",
                             "Buffer Flush"})
NAME = 120      # characters kept of a kernel's or host event's name


def profile(unit, units, device, counters, label):
    """Runs ``unit`` (one frame or step, ending in a sync) ``units`` times
    under torch.profiler, each inside a host span ``label`` (so that the
    host's own work between the program's calls is named in the idle
    gaps), after one unit under a profiler of its own (the profiler's
    start-up stays out of the traced window). ``counters``: a function
    that reads the program's launch counters, whose deltas over the units
    the profile keeps. Returns (profile, breakdown)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    from rtbench.harness.port import sync

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts):
        unit()
        sync(device)
    before = counters()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            with record_function(label):
                unit()
        sync(device)
        wall = time.perf_counter() - t0
    after = counters()
    kernels = {}
    # the span ``label`` shows on the device's timeline too: it is no work
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and e.key != label):
            k = kernels.setdefault(e.key, dict(us=0.0, count=0))
            k["us"] += e.self_device_time_total
            k["count"] += e.count
    out = dict(units=units, wall_s=wall, kernels=kernels,
               counters={k: after[k] - before[k] for k in after})
    device, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type != DeviceType.CUDA:
            host.append(span)
        elif e.name != label:
            device.append(span)
    return out, breakdown(out, device, host)


def idle_gaps(device, host, top=10):
    """The ``top`` longest gaps between the device's busy intervals
    (``device``: (start_us, end_us, name)), longest first, each named by
    the innermost host event (``host``, the same form) that spans its
    middle: [name, seconds]."""
    spans = sorted((s, e) for s, e, _ in device)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        around = [(he - hs, name) for hs, he, name in host
                  if hs <= mid <= he and name not in PROFILER_EVENTS]
        name = min(around)[1] if around else "(no host event)"
        out.append([name[:NAME], (e - s) / 1e6])
    return out


def breakdown(prof, device, host):
    """The result line's breakdown: the 10 device operations that took
    most time, and the 10 longest idle gaps, [name, seconds] each."""
    ops = sorted(prof["kernels"].items(), key=lambda kv: -kv[1]["us"])[:10]
    return dict(device_ops=[[k[:NAME], v["us"] / 1e6] for k, v in ops],
                idle_gaps=idle_gaps(device, host))
