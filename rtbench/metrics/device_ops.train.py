"""Device events a train in the profiled trains: every kernel, copy and
set the card ran."""

from rtbench.metrics._kernels import events


def read(layer):
    p = layer.get("profile")
    if layer["kind"] != "train" or not p or not p["kernels"]:
        return None
    return events(p) / p["units"]
