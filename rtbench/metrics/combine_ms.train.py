"""Host milliseconds a train step spends on the eager sums of its
microbatches' losses and gradients, and on the rays' backward for a
camera (the spans ``train.combine``, summed over the step), the median
over the unprofiled steps."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "train":
        return None
    return _spans.median_ms(_spans.TRAIN_ROOTS, ("train.combine",))
