"""Frame traffic: a closed loop of whole frames, one after another, as a
user of the command line or the library renders them:
``render(scene, camera, quantize=True)``, each ending in its copy to the
host. Every frame of the window is held against the reference's frame.

Traffic keys: ``warmup`` (frames in set-up; the first captures the tile
program), ``profile_units`` (frames under the profiler with ``--trace
1``)."""

from __future__ import annotations

import time

import numpy as np

from rtbench.harness import common, port, trace
from rtbench.loops.base import Loop


class Cell(Loop):
    kind = "frame"

    def setup(self):
        from raytracer_tpu_torch.core import tile_program

        self.desc = self.cfg_mod.describe(self.cfg, self.seed)
        t = time.perf_counter()
        self.camera, self.scene = self.cfg_mod.port_scene(
            self.cfg, self.desc, self.work, self.device)
        port.sync(self.device)
        self.parse_build_s = time.perf_counter() - t
        for _ in range(self.traffic["warmup"]):
            self.unit()
        prog = tile_program.program_of(self.scene)
        self.capture_s = prog.stats["capture_s"] if prog else 0.0

    def unit(self):
        from raytracer_tpu_torch.core.render import render

        return render(self.scene, self.camera, quantize=True)

    def window(self, seconds):
        """Frames until ``seconds`` have passed: (end-to-end metrics,
        frames attempted, frames failed)."""
        frames, lat = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            frames.append(self.unit())
            lat.append(time.perf_counter() - ts)
        total = time.perf_counter() - t0
        self.frames, self.lat = frames, lat
        self.frame_s = common.window_rate(total, len(frames))
        return dict(frame_s=self.frame_s), len(frames), 0

    def trace(self):
        n = self.traffic["profile_units"]
        prof, bd = trace.profile(self.unit, n, self.device,
                                 port.launch_counts, "rtbench.frame")
        layer = dict(kind="frame", parse_build_s=self.parse_build_s,
                     capture_s=self.capture_s, unit_s=self.frame_s,
                     unit_lats=self.lat, profile=prof)
        return layer, bd

    def release(self):
        del self.scene, self.camera
        port.free(self.device)

    def check(self, limits):
        """Every frame of the window against the reference's frame: the
        worst frame's share of pixels with a channel more than one step
        off."""
        import torch

        from rtbench.reference import tracer

        want = tracer.render_u8(tracer.Scene(
            self.desc, device=self.device, dtype=torch.float32))
        worst = max(px_off(f, want) for f in self.frames)
        return {"px_off": common.check(worst, limits["px_off"])}


def px_off(frame, reference):
    """The share of pixels of ``frame`` with a channel more than one step
    from ``reference``'s (1 where the shapes differ)."""
    if frame.shape != reference.shape:
        return 1.0
    diff = np.abs(frame.astype(np.int16) - reference.astype(np.int16))
    return float((diff.max(-1) > 1).mean())
