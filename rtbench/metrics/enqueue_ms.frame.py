"""Host milliseconds a frame spends enqueueing its tiles (the span
``frame.enqueue``: a graph launch and the copies per tile, and the level
logs' copy), the median over the unprofiled frames."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "frame":
        return None
    return _spans.median_ms(_spans.FRAME_ROOTS, ("frame.enqueue",))
