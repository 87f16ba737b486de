"""Render observability: rays/sec counters, the program's own spans and a
profiler hook.

Counterpart of ``raytracer_tpu/utils/profiling.py``: a small stats object
the renderer entry points feed, and a context manager around
``torch.profiler`` (the JAX package's wraps ``jax.profiler``) that writes a
Chrome trace, viewable in Perfetto or ``chrome://tracing``.

The span recorder times the phases of a frame and of a train step from
inside the program (``core/render.render``, ``core/tile_program``,
``core/train_program``, ``parallel/train``)::

    from raytracer_tpu_torch.utils import profiling
    profiling.enable()
    render(scene, camera)
    for s in profiling.spans():
        print(s.name, s.duration_ns, s.self_ns, s.rid, s.attrs)

It is off by default: :func:`span` then returns one shared no-op object
after a single flag test, with no clock read. On, each span keeps its
name, its start and end (``time.perf_counter_ns``), its parent's number and
its request id (the number of its root span: every span of one frame or
one step shares it), whether ``torch.profiler`` was running when it
started (``profiled``: CUPTI slows the host's launches then), and its
``attrs``. Spans are kept in a bounded buffer, the oldest dropped past its
capacity (:func:`dropped` counts them). A unit that times its device work
with CUDA events (:func:`device_span`) gets ``attrs["device_ms"]`` on its
root once the end event has completed. :func:`unix_ns` puts a span on the
clock of ``torch.profiler``'s Kineto events (``start_ns()``), so that a
span can be laid beside the kernels it launched.

Spans are plain host timers: they are not ``record_function`` ranges,
which the profiler would mirror onto the device's timeline. Stage marks
(:func:`mark`: ``area_light`` around ``core/render._area_light_contrib``,
``csg_filter`` around ``core/csg.apply_csg``'s body) are such ranges, opened
only while the recorder is on and ``torch.profiler`` runs, so that the
kernels an eager frame launches inside a stage can be summed by stage.
:func:`add_to_root` adds a count to the open root span's ``attrs``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field

_now = time.perf_counter_ns
CAPACITY = 1 << 16     # spans kept; a flagship train step records about 16

_on = False
_buf: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_base = (0, 0)         # (time.time_ns(), perf_counter_ns()) at enable()
_profiler_on = None    # torch.autograd._profiler_enabled, bound at enable()
_device = collections.deque(maxlen=CAPACITY)   # (root, start, end) events


@dataclass
class RenderStats:
    """Accumulates per-tile wall-clock and ray counts."""

    primary_rays: int = 0
    tiles: int = 0
    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start_tile(self):
        self._t0 = time.perf_counter()

    def end_tile(self, n_rays: int):
        self.seconds += time.perf_counter() - self._t0
        self.primary_rays += n_rays
        self.tiles += 1

    @property
    def rays_per_sec(self) -> float:
        return self.primary_rays / self.seconds if self.seconds else 0.0

    def summary(self) -> str:
        return (
            f"{self.primary_rays} primary rays in {self.seconds:.2f}s "
            f"over {self.tiles} tiles = {self.rays_per_sec:,.0f} rays/s"
        )


# -- spans -----------------------------------------------------------------
def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One timed phase (see the module docstring). ``sid``: its number;
    ``parent``: its parent's number (None for a root); ``rid``: the
    request id, its root's number; ``start``, ``end``: perf_counter_ns;
    ``child_ns``: the time its children cover; ``profiled``; ``attrs``."""

    __slots__ = ("name", "attrs", "sid", "parent", "rid", "start", "end",
                 "child_ns", "profiled", "_kept")

    def __init__(self, name, kept):
        self.name, self.attrs, self._kept = name, {}, kept
        self.sid = self.parent = self.rid = self.start = self.end = None
        self.child_ns = 0
        self.profiled = False

    def __enter__(self):
        if self._kept:
            stack = _stack()
            self.sid = next(_ids)
            if stack:
                self.parent, self.rid = stack[-1].sid, stack[-1].rid
            else:
                self.rid = self.sid
            self.profiled = bool(_profiler_on())
            stack.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc):
        self.end = _now()
        if self._kept:
            global _dropped
            stack = _stack()
            stack.pop()
            if stack:
                stack[-1].child_ns += self.end - self.start
            if len(_buf) == _buf.maxlen:
                _dropped += 1
            _buf.append(self)
        return False

    @property
    def duration_ns(self) -> int:
        return self.end - self.start

    @property
    def self_ns(self) -> int:
        """The span's duration less the part its children cover."""
        return self.end - self.start - self.child_ns

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class _Off:
    """The shared no-op span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Off()


def span(name: str):
    """A span ``name`` around a ``with`` block, nested under the span open
    on this thread: recorded while the recorder is on, else :data:`NOOP`."""
    if _on:
        return Span(name, True)
    return NOOP


def mark(name: str):
    """A stage mark ``name`` around a ``with`` block: a
    ``torch.profiler.record_function`` range while the recorder is on and
    torch's profiler is running, outside a CUDA graph capture; else
    :data:`NOOP` (one flag test while the recorder is off). A range adds
    no work on the device: the kernels launched inside it are attributed
    to it, so an eager frame's device time can be summed by stage; a
    graph replay's kernels are launched by the replay, not inside it."""
    if _on and _profiler_on() and not _capturing():
        from torch.profiler import record_function

        return record_function(name)
    return NOOP


def _capturing() -> bool:
    import torch

    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def add_to_root(key: str, n) -> None:
    """Adds ``n`` to the open root span's ``attrs[key]`` (from 0) while
    the recorder is on; nothing otherwise, or without an open root."""
    if _on:
        root = current_root()
        if root is not None:
            root.attrs[key] = root.attrs.get(key, 0) + n


def timed(name: str):
    """A span that reads its clock even while the recorder is off (for a
    program's own counters of rare phases, such as ``capture_s``): recorded
    while the recorder is on. Its ``seconds`` hold after the block."""
    return Span(name, _on)


def enable():
    """Turns the recorder on. Stores the pair (``time.time_ns()``,
    ``perf_counter_ns()``) that :func:`unix_ns` converts with."""
    global _on, _base, _profiler_on
    import torch

    _profiler_on = torch.autograd._profiler_enabled
    _base = (time.time_ns(), _now())
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clear():
    """Forgets the recorded spans, the drop count and the device spans
    still waiting for their events."""
    global _dropped
    _buf.clear()
    _device.clear()
    _dropped = 0


def spans() -> list:
    """The recorded spans, oldest first (by end), with the device spans
    whose events have completed attached."""
    resolve_device_spans()
    return list(_buf)


def dropped() -> int:
    """Spans dropped past the buffer's capacity."""
    return _dropped


def current_root():
    """The root span open on this thread, or None."""
    stack = _stack()
    return stack[0] if stack else None


def unix_ns(perf_ns: int) -> int:
    """``perf_ns`` (a span's clock) in Unix nanoseconds, the base of
    ``torch.profiler``'s Kineto events."""
    return _base[0] + perf_ns - _base[1]


def device_span(start, end):
    """Gives the open root span the card's time between two timing CUDA
    events, ``start`` and ``end`` (recorded by the caller), as
    ``attrs["device_ms"]`` once ``end`` has completed: read without a sync,
    at the unit's own (:func:`resolve_device_spans`) or at :func:`spans`."""
    root = current_root()
    if root is not None:
        _device.append((root, start, end))


def resolve_device_spans():
    """Attaches the device spans whose end events have completed, in the
    order they were recorded; queries the events, never waits."""
    while _device and _device[0][2].query():
        root, start, end = _device.popleft()
        root.attrs["device_ms"] = start.elapsed_time(end)


def _chrome_events(recorded, base_ns):
    """The spans as Chrome trace events on a host track of their own,
    ``ts`` in microseconds after ``base_ns`` (the trace's
    ``baseTimeNanoseconds``)."""
    pid = "program spans"
    out = [dict(ph="M", name="process_name", pid=pid, tid=0,
                args=dict(name=pid))]
    for s in recorded:
        out.append(dict(
            ph="X", cat="span", name=s.name, pid=pid, tid=0,
            ts=(unix_ns(s.start) - base_ns) / 1e3,
            dur=(s.end - s.start) / 1e3,
            args=dict(sid=s.sid, parent=s.parent, rid=s.rid,
                      profiled=s.profiled, self_us=s.self_ns / 1e3,
                      **s.attrs)))
    return out


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Profile the block with ``torch.profiler`` (host ops, and the card's
    kernels when CUDA is available) and write ``trace.json``, a Chrome
    trace, into ``log_dir``. The span recorder is on for the block, and its
    spans go into the trace as a host track of their own ("program spans")
    on the profiler's clock. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    enable()
    first = next(_ids)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    recorded = [s for s in spans() if s.sid > first]
    trace["traceEvents"].extend(_chrome_events(
        recorded, int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)
