"""Device milliseconds a frame of the table_gather kernels in the
profiled frames."""

from rtbench.metrics._kernels import GATHER_KERNELS, kernel_sum


def read(layer):
    p = layer.get("profile")
    if layer["kind"] != "frame" or not p:
        return None
    us, count = kernel_sum(p, GATHER_KERNELS)
    return us / 1e3 / p["units"] if count else None
