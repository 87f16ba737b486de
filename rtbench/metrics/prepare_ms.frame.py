"""Host milliseconds a frame spends before its first tile launch (the
program's span ``frame.prepare``: the tile order and its upload, the
camera, the program found and the camera set), the median over the
unprofiled frames."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "frame":
        return None
    return _spans.median_ms(_spans.FRAME_ROOTS, ("frame.prepare",))
