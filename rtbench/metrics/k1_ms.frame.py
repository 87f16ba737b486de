"""Device milliseconds a frame of the mesh kernels K1 (walk and finish)
and K1b in the profiled frames; nothing where the frames ran none, or
where the profiler's K1 and K1b events differ from the launch counters."""

import sys

from rtbench.metrics._kernels import K1_KERNELS, counted_k1, kernel_sum


def read(layer):
    p = layer.get("profile")
    if layer["kind"] != "frame" or not p:
        return None
    us, count = kernel_sum(p, K1_KERNELS)
    if count == 0:
        return None
    if not counted_k1(p):
        print("k1_ms.frame: the profiler's K1/K1b events differ from the "
              f"launch counters {p['counters']}", file=sys.stderr)
        return None
    return us / 1e3 / p["units"]
