"""The device's idle share in a train: 1 - (the profiled trains' device
busy time a train) / (the same process's unprofiled seconds a train)."""

from rtbench.metrics._kernels import busy_us


def read(layer):
    p = layer.get("profile")
    if layer["kind"] != "train" or not p or not p["kernels"]:
        return None
    return 1.0 - busy_us(p) / 1e6 / p["units"] / layer["unit_s"]
