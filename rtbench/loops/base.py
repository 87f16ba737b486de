"""What every traffic loop shares: its inputs, and a closed loop of
steps over a window."""

from __future__ import annotations

import time

from rtbench.harness import common


class Loop:
    """A cell's run: ``setup``, ``window``, ``trace``, ``release`` and
    ``check``, in that order (harness/cell.py)."""

    def __init__(self, cfg, cfg_mod, traffic, seed, work, device):
        self.cfg, self.cfg_mod, self.traffic = cfg, cfg_mod, traffic
        self.seed, self.work, self.device = seed, work, device

    def window(self, seconds):
        """Steps (``unit``) one after another until ``seconds`` have
        passed: (end-to-end metrics, steps attempted, steps failed)."""
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.unit()
            steps += 1
        self.step_s = common.window_rate(time.perf_counter() - t0, steps)
        return dict(step_s=self.step_s), steps, 0
