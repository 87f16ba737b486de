"""Render operations: checkpoint/resume and profiling (counterpart of
``raytracer_tpu/utils``).

The names load on first use: the renderer's own modules import
``utils.profiling`` (its span recorder), and ``utils.checkpoint`` imports
the renderer."""

__all__ = ["render_resumable", "RenderStats", "trace_profile"]


def __getattr__(name):
    if name == "render_resumable":
        from raytracer_tpu_torch.utils.checkpoint import render_resumable
        return render_resumable
    if name in ("RenderStats", "trace_profile"):
        from raytracer_tpu_torch.utils import profiling
        return getattr(profiling, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
