"""Rows the level steps shade a frame, in millions: the program's own count
(``attrs["rows_shaded"]`` on the frame's root span: level 0's rays, and
every later level that ran at the width its level log records, or at its
rows where it ran whole), the median over the unprofiled frames. Nothing
where the program records no such count."""

import statistics

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "frame":
        return None
    got = [s.attrs["rows_shaded"] for s in _spans.spans()
           if s.parent is None and s.name in _spans.FRAME_ROOTS
           and not s.profiled and "rows_shaded" in s.attrs]
    return statistics.median(got) / 1e6 if got else None
