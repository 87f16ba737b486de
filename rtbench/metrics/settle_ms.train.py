"""Milliseconds a train step spends in its one read of the card (the span
``train.settle``: the wait for the level logs, and the launches counted),
the median over the unprofiled steps."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "train":
        return None
    return _spans.median_ms(_spans.TRAIN_ROOTS, ("train.settle",))
