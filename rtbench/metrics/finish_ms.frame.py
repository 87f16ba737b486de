"""Host milliseconds a frame spends after its copy has arrived (the spans
``frame.settle``, the level logs read and the launches counted, and
``frame.scatter``, the pixels put in image order), the median over the
unprofiled frames."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "frame":
        return None
    return _spans.median_ms(_spans.FRAME_ROOTS,
                            ("frame.settle", "frame.scatter"))
