"""The table_gather kernels' share of their roofline in a train step, in
%: the least time that every lookup of one step could take (its bytes,
each input byte read once and each output byte written once, over the
H100's 3.35 TB/s; the calls recorded from one ``graphs=False`` step on
the same state, which takes the same branches) over the kernels' device
time a step in the profiled graphed steps. A graphed step runs every
lookup's backward where the eager one runs those the loss reaches, so
the share is if anything low."""

from rtbench.metrics._gathers import bound_s
from rtbench.metrics._kernels import GATHER_KERNELS, kernel_sum


def read(layer):
    p, calls = layer.get("profile"), layer.get("gather_calls")
    if layer["kind"] != "train" or not p or not calls:
        return None
    us, count = kernel_sum(p, GATHER_KERNELS)
    if not count:
        return None
    return 100.0 * bound_s(calls) / (us / 1e6 / p["units"])
