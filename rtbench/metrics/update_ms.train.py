"""Host milliseconds a train step spends on its scene's partition, the
SGD update and the new scene (the spans ``step.update``), the median over
the unprofiled steps."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "train":
        return None
    return _spans.median_ms(_spans.TRAIN_ROOTS, ("step.update",))
