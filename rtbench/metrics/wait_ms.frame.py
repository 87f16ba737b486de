"""Milliseconds a frame's host spends blocked on the card (the span
``frame.wait``: the frame's copy to the host), the median over the
unprofiled frames."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "frame":
        return None
    return _spans.median_ms(_spans.FRAME_ROOTS, ("frame.wait",))
