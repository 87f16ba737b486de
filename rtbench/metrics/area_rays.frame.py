"""Shadow-sample rays the area-light stage queries a frame, in millions:
the program's own count (``attrs["area_rays"]`` on the frame's root span:
each level that ran, at the width its level log records or at its rows
where it ran whole, times S samples of each area light), the median over
the unprofiled frames. It is the count that a later kernel of the stage
divides its time by. Nothing where the program records no such count."""

import statistics

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "frame":
        return None
    got = [s.attrs["area_rays"] for s in _spans.spans()
           if s.parent is None and s.name in _spans.FRAME_ROOTS
           and not s.profiled and "area_rays" in s.attrs]
    return statistics.median(got) / 1e6 if got else None
