"""Device events a frame in the profiled frames: every kernel, copy and
set the card ran."""

from rtbench.metrics._kernels import events


def read(layer):
    p = layer.get("profile")
    if layer["kind"] != "frame" or not p or not p["kernels"]:
        return None
    return events(p) / p["units"]
