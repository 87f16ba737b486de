"""Train traffic: SGD on every float table of the scene through
``parallel.train.train_step``, fitting a start perturbed from the seed to
the frame of the scene itself, one step after another, each ending in the
step's own sync.

Set-up builds the one state that the window steps, and drives it through
its first ``checked_steps`` steps (the first captures the train program);
those steps are held against the reference's. Traffic keys: ``rays``
([hsize, vsize] of the batch, in render's 16x16-block order), ``n_micro``,
``remat``, ``lr``, ``checked_steps``, ``profile_units``."""

from __future__ import annotations

import sys
import time

import numpy as np

from rtbench.harness import common, compare, port, trace
from rtbench.loops.base import Loop


def port_leaves(params):
    """The program's tables as the reference names its leaves: the
    material table split by column, the others by their own name."""
    from raytracer_tpu_torch.core import types as T

    cols = {"color": T.MAT_COLOR, "ambient": T.MAT_AMBIENT,
            "diffuse": T.MAT_DIFFUSE, "specular": T.MAT_SPECULAR,
            "shininess": T.MAT_SHININESS, "reflective": T.MAT_REFLECTIVE,
            "transparency": T.MAT_TRANSPARENCY,
            "refractive_index": T.MAT_REFRACTIVE}
    out = {}
    for k, v in params.items():
        v = v.detach().float().cpu().numpy().copy()
        if k == "mat":
            for name, c in cols.items():
                out[f"mat.{name}"] = v[:, c]
        else:
            out[k] = v
    return out


def train_camera(desc, traffic):
    cam = dict(desc["camera"])
    cam["hsize"], cam["vsize"] = traffic["rays"]
    return cam


class Cell(Loop):
    kind = "train"

    def setup(self):
        import torch

        from raytracer_tpu_torch.camera import Camera, ray_grid
        from raytracer_tpu_torch.core.render import color_at
        from raytracer_tpu_torch.parallel import partition_scene

        tr = self.traffic
        self.desc = self.cfg_mod.describe(self.cfg, self.seed)
        self.start = self.cfg_mod.train_start(self.cfg, self.desc, self.seed)
        self.cam = train_camera(self.desc, tr)
        t = time.perf_counter()
        camera, truth = self.cfg_mod.port_scene(self.cfg, self.desc,
                                                self.work, self.device)
        _, self.scene = self.cfg_mod.port_scene(self.cfg, self.start,
                                                self.work, self.device)
        port.sync(self.device)
        self.parse_build_s = time.perf_counter() - t
        cam = Camera(*tr["rays"], camera.field_of_view).with_transform(
            camera.transform)
        order = torch.as_tensor(port.block_order(cam.vsize, cam.hsize),
                                device=self.device)
        o, d = ray_grid(cam, device=self.device)
        self.o, self.d = o[order].contiguous(), d[order].contiguous()
        with torch.no_grad():
            self.target = color_at(truth, self.o, self.d)
        del truth
        self.hist = [port_leaves(partition_scene(self.scene)[0])]
        self.losses = []
        for _ in range(tr["checked_steps"]):
            self.losses.append(float(self.unit()))
            self.hist.append(port_leaves(partition_scene(self.scene)[0]))
        self.capture_s = port.train_capture_s()

    def unit(self):
        from raytracer_tpu_torch.parallel import train_step

        tr = self.traffic
        loss, self.scene = train_step(
            self.scene, self.o, self.d, self.target, lr=tr["lr"],
            n_micro=tr["n_micro"], remat=tr["remat"])
        port.sync(self.device)
        return loss

    def eager_step(self):
        """One step of ``graphs=False`` on the same state, its result
        dropped: the lookups that a step makes, for the gathers' bound."""
        from raytracer_tpu_torch.parallel import train_step

        tr = self.traffic
        train_step(self.scene, self.o, self.d, self.target, lr=tr["lr"],
                   n_micro=tr["n_micro"], remat=tr["remat"], graphs=False)
        port.sync(self.device)

    def trace(self):
        from raytracer_tpu_torch.ops import gather_cuda

        from rtbench.metrics._gathers import GatherRecorder

        n = self.traffic["profile_units"]
        prof, bd = trace.profile(self.unit, n, self.device,
                                 port.launch_counts, "rtbench.step")
        with GatherRecorder(gather_cuda) as rec:
            self.eager_step()
        layer = dict(kind="train", parse_build_s=self.parse_build_s,
                     capture_s=self.capture_s, unit_s=self.step_s,
                     profile=prof, gather_calls=rec.summary())
        return layer, bd

    def release(self):
        del self.scene, self.o, self.d, self.target
        port.drop_train_programs()
        port.free(self.device)

    def reference_run(self, dtype=None):
        """(losses, leaves before and after each step) of the reference
        (in ``dtype``: the control) over the same steps."""
        import torch

        from rtbench.reference.train import sgd_run

        losses, hist = sgd_run(
            self.desc, self.start, self.cam, lr=self.traffic["lr"],
            steps=self.traffic["checked_steps"], device=self.device,
            dtype=dtype or torch.float32)
        return losses, [{k: v.float().cpu().numpy() for k, v in h.items()}
                        for h in hist]

    def numbers(self, losses, hist):
        nums, self.grad_leaves, self.change_leaves = compare.sgd_numbers(
            self.hist, hist, self.losses, losses, self.traffic["lr"])
        stray = [k for k in self.hist[0] if k not in hist[0]]
        nums["stray_change"] = max(
            [float(np.abs(self.hist[-1][k].astype(np.float64)
                          - self.hist[0][k]).max(initial=0.0))
             for k in stray], default=0.0)
        return nums

    def check(self, limits):
        """The first steps against the reference's: the losses, the first
        gradient and the change over the steps, each by the worst leaf;
        and no change at all in a table the reference does not have."""
        losses, hist = self.reference_run()
        nums = self.numbers(losses, hist)
        print(f"losses: program {self.losses!r}, reference {losses!r}; "
              f"leaves of the gradient {self.grad_leaves}, of the change "
              f"{self.change_leaves}",
              file=sys.stderr)
        return {k: common.check(v, limits[k]) for k, v in nums.items()}
