"""Pose traffic: fitting the camera's eye to a frame, as
``examples/inverse_render --pose`` does. The rays come from the
differentiable camera (``camera.view_transform_tensor``,
``camera.ray_grid_tensor``) at an eye perturbed from the seed, in render's
16x16-block order; the target is the frame from the true eye; each step
is ``parallel.render_loss_and_grad`` with no scene parameter (the rays
require grad), its gradient carried back into the eye, then a
``torch.optim.Adam`` step, ending in a sync.

Set-up builds the one eye and optimizer that the window steps and drives
them through their first ``checked_steps`` steps (the first captures the
train program); those are held against the reference's. Traffic keys:
``rays`` ([hsize, vsize]), ``lr``, ``eye_jitter`` (the start's offset from
the true eye, uniform in +-jitter on each axis), ``checked_steps``,
``profile_units``."""

from __future__ import annotations

import sys
import time

import numpy as np

from rtbench.harness import common, compare, port, trace
from rtbench.loops.base import Loop
from rtbench.loops.train import train_camera


class Cell(Loop):
    kind = "train"

    def rays(self, eye):
        import torch

        from raytracer_tpu_torch.camera import (ray_grid_tensor,
                                                view_transform_tensor)

        cam = self.cam
        inv = torch.linalg.inv(view_transform_tensor(
            eye, torch.tensor(cam["to"], device=self.device),
            torch.tensor(cam["up"], device=self.device)))
        o, d = ray_grid_tensor(inv, cam["hsize"], cam["vsize"], cam["fov"])
        return o.index_select(0, self.order), d.index_select(0, self.order)

    def setup(self):
        import torch

        from raytracer_tpu_torch.core.render import color_at

        tr = self.traffic
        self.desc = self.cfg_mod.describe(self.cfg, self.seed)
        self.cam = train_camera(self.desc, tr)
        t = time.perf_counter()
        _, self.scene = self.cfg_mod.port_scene(self.cfg, self.desc,
                                                self.work, self.device)
        port.sync(self.device)
        self.parse_build_s = time.perf_counter() - t
        self.order = torch.as_tensor(port.block_order(
            self.cam["vsize"], self.cam["hsize"]), device=self.device)
        true_eye = torch.tensor(self.cam["from"], dtype=torch.float32,
                                device=self.device)
        with torch.no_grad():
            self.target = color_at(self.scene, *self.rays(true_eye))
        rng = np.random.default_rng([self.seed, 2])
        j = tr["eye_jitter"]
        self.eye0 = (np.asarray(self.cam["from"], np.float64)
                     + rng.uniform(-j, j, 3)).astype(np.float32)
        self.eye = torch.tensor(self.eye0, device=self.device,
                                requires_grad=True)
        self.opt = torch.optim.Adam([self.eye], lr=tr["lr"])
        self.hist = [self.eye0]
        self.losses, self.moments = [], []
        steps = tr["checked_steps"]
        for s in range(steps):
            self.losses.append(float(self.unit()))
            if s in (0, steps - 1):
                # no state: no gradient reached the eye
                m = self.opt.state[self.eye].get("exp_avg")
                self.moments.append(np.zeros(3, np.float32) if m is None
                                    else m.cpu().numpy().copy())
            self.hist.append(self.eye.detach().cpu().numpy().copy())
        self.capture_s = port.train_capture_s()

    def loss_and_grad(self, graphs=True):
        from raytracer_tpu_torch.parallel import render_loss_and_grad

        loss, _ = render_loss_and_grad({}, lambda _: self.scene,
                                       *self.rays(self.eye), self.target,
                                       remat=False, graphs=graphs)
        return loss

    def unit(self):
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_and_grad()
        self.opt.step()
        port.sync(self.device)
        return loss

    def trace(self):
        from raytracer_tpu_torch.ops import gather_cuda

        from rtbench.metrics._gathers import GatherRecorder

        n = self.traffic["profile_units"]
        prof, bd = trace.profile(self.unit, n, self.device,
                                 port.launch_counts, "rtbench.step")
        self.opt.zero_grad(set_to_none=True)
        with GatherRecorder(gather_cuda) as rec:
            self.loss_and_grad(graphs=False)
            port.sync(self.device)
        layer = dict(kind="train", parse_build_s=self.parse_build_s,
                     capture_s=self.capture_s, unit_s=self.step_s,
                     profile=prof, gather_calls=rec.summary())
        return layer, bd

    def release(self):
        del self.scene, self.target, self.opt
        port.drop_train_programs()
        port.free(self.device)

    def reference_run(self, dtype=None):
        """(losses, eyes, Adam's first moment after the first and the last
        step) of the reference (in ``dtype``: the control) over the same
        steps."""
        import torch

        from rtbench.reference.train import adam_pose_run

        losses, hist, moments = adam_pose_run(
            self.desc, self.cam, self.eye0, lr=self.traffic["lr"],
            steps=self.traffic["checked_steps"], device=self.device,
            dtype=dtype or torch.float32)
        return (losses, [h.float().cpu().numpy() for h in hist],
                [m.float().cpu().numpy() for m in moments])

    def numbers(self, losses, hist, moments):
        return compare.adam_numbers(self.losses, losses, self.moments,
                                    moments)

    def check(self, limits):
        """The first steps against the reference's: the losses, the first
        gradient and every step's (from Adam's first moment)."""
        ref = self.reference_run()
        nums = self.numbers(*ref)
        print(f"losses: program {self.losses!r}, reference {ref[0]!r}; "
              f"eye: program {self.hist[-1].tolist()}, reference "
              f"{ref[1][-1].tolist()}", file=sys.stderr)
        return {k: common.check(v, limits[k]) for k, v in nums.items()}
