"""The card's milliseconds from a frame's first enqueued work to its last,
gaps inside included (a pair of CUDA events the tile program records
while the span recorder is on, read at the frame's own sync), the median
over the unprofiled frames."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "frame":
        return None
    return _spans.device_ms(_spans.FRAME_ROOTS)
