"""The card's milliseconds from a train step's first microbatch's work to
its last (a pair of CUDA events on the train program's stream while the
span recorder is on), gaps inside included, the median over the
unprofiled steps."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "train":
        return None
    return _spans.device_ms(_spans.TRAIN_ROOTS)
