"""Host milliseconds a train step spends launching its microbatches'
forward and backward graphs (the spans ``train.forward`` and
``train.backward``, summed over the step), the median over the
unprofiled steps."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "train":
        return None
    return _spans.median_ms(_spans.TRAIN_ROOTS,
                            ("train.forward", "train.backward"))
