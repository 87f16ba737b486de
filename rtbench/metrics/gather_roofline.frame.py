"""The table_gather kernels' share of their roofline in a frame, in %: the
bytes the profiled frames' calls must move (the program's
``gather_bytes`` counter: each input byte read once, each output byte
written once) over the H100's 3.35 TB/s, over the kernels' device time
in the same frames."""

from rtbench.metrics._kernels import GATHER_KERNELS, PEAK_BYTES_PER_S
from rtbench.metrics._kernels import kernel_sum


def read(layer):
    p = layer.get("profile")
    if layer["kind"] != "frame" or not p:
        return None
    moved = p["counters"].get("gather_bytes")
    us, count = kernel_sum(p, GATHER_KERNELS)
    if not moved or not count:
        return None
    return 100.0 * moved / PEAK_BYTES_PER_S / (us / 1e6)
