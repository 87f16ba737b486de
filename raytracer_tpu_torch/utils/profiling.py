"""Render observability: rays/sec counters and a profiler hook.

Counterpart of ``raytracer_tpu/utils/profiling.py``: a small stats object
the renderer entry points feed, and a context manager around
``torch.profiler`` (the JAX package's wraps ``jax.profiler``) that writes a
Chrome trace, viewable in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


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


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Profile the block with ``torch.profiler`` (host ops, and the card's
    kernels when CUDA is available) and write ``trace.json``, a Chrome
    trace, into ``log_dir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
