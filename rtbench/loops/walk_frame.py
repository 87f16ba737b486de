"""Frame traffic checked against the walk reference: the frame loop of
``frame.py`` (a closed loop of ``render(scene, camera, quantize=True)``,
each frame ending in its copy to the host), with every frame of the
window held against ``reference/walk.py``'s frame in place of
``reference/tracer.py``'s. For scenes with transparent meshes, which
tracer.py refuses. Traffic keys: those of ``frame.py``."""

from __future__ import annotations

from rtbench.harness import common
from rtbench.loops import frame


class Cell(frame.Cell):
    def check(self, limits):
        """Every frame of the window against the walk reference's frame:
        the worst frame's share of pixels with a channel more than one
        step off."""
        import torch

        from rtbench.reference import walk

        want = walk.render_u8(walk.Scene(
            self.desc, device=self.device, dtype=torch.float32))
        worst = max(frame.px_off(f, want) for f in self.frames)
        return {"px_off": common.check(worst, limits["px_off"])}
