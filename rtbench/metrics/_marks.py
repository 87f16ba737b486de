"""The stage marks of the marked frame that ``loops/area_frame.py`` adds
to a traced run (``layer["marks"]``: by mark, the device microseconds of
the kernels launched inside its ``record_function`` ranges and the
ranges' count; ``"frame"``: the whole marked frame's).

The marked frame is a ``graphs=False`` frame: its kernels are the graphed
frames' launched one by one from the host, so a stage's share of it is
the share the stage holds of a graphed frame's device work, and its
milliseconds are the eager kernels'. Importing this module turns the
program's span recorder on (``_spans``), without which the program opens
no mark."""

from rtbench.metrics import _spans  # noqa: F401  (turns the recorder on)


def mark_ms(layer, name):
    """Device ms of the kernels launched inside the mark ``name`` in the
    marked frame; None without a marked frame, without device time (the
    CPU) or where the program opened no such mark."""
    marks = layer.get("marks")
    if layer["kind"] != "frame" or not marks:
        return None
    if not marks.get("frame", {}).get("us"):
        return None
    got = marks.get(name)
    if not got or not got["count"]:
        return None
    return got["us"] / 1e3
