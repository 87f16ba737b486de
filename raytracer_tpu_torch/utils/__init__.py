"""Render operations: checkpoint/resume and profiling (counterpart of
``raytracer_tpu/utils``)."""

from raytracer_tpu_torch.utils.checkpoint import render_resumable
from raytracer_tpu_torch.utils.profiling import RenderStats, trace_profile

__all__ = ["render_resumable", "RenderStats", "trace_profile"]
