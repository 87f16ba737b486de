"""Device milliseconds a train of every event that is not a hand-written
kernel (PyTorch's kernels, copies and sets) in the profiled trains."""

from rtbench.metrics._kernels import HAND_KERNELS, busy_us, kernel_sum


def read(layer):
    p = layer.get("profile")
    if layer["kind"] != "train" or not p or not p["kernels"]:
        return None
    return (busy_us(p) - kernel_sum(p, HAND_KERNELS)[0]) / 1e3 / p["units"]
