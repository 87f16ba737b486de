"""The device's idle share in a frame: 1 - (the profiled frames' device
busy time a frame) / (the same process's unprofiled seconds a frame)."""

from rtbench.metrics._kernels import busy_us


def read(layer):
    p = layer.get("profile")
    if layer["kind"] != "frame" or not p or not p["kernels"]:
        return None
    return 1.0 - busy_us(p) / 1e6 / p["units"] / layer["unit_s"]
