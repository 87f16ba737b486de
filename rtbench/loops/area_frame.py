"""Frame traffic of scenes with area lights and CSG, checked against
``reference/csg_area.py``: the frame loop of ``frame.py`` (a closed loop
of ``render(scene, camera, quantize=True)``, each frame ending in its copy
to the host; the program's jitter from render's default generator), with
a check that allows for random jitter, and one marked frame more in the
traced stretch. Traffic keys: those of ``frame.py``.

The program and the reference draw their jitter from different streams,
so their frames cannot agree pixel for pixel where a pixel's value rests
on where the samples fall. Every frame of the window is held to the
reference's frame under its own random jitter (seeded with ``--seed``) by
two numbers:

* ``px_off_hard``: the share of pixels with a channel more than one step
  off the reference's, counted outside the noise band. The band is the
  pixels that differ among four frames of the reference with constant
  jitter, every sample at one corner of its cell: (0.001, 0.001),
  (0.999, 0.999), (0.001, 0.999) and (0.999, 0.001) as (u, v);
* ``block_gap``: the largest absolute difference, in u8 steps, between
  the program's and the reference's means over 8 x 8 pixel blocks (a
  partial block at the frame's edge is its own block).

The traced stretch (``--trace 1``) adds, after ``frame.py``'s graphed
profiled frames, one ``graphs=False`` frame (the same default generator)
under a ``torch.profiler`` of its own. There the program's stage
marks (``utils/profiling.mark``: ``area_light``, ``csg_filter``) are
``record_function`` ranges, and the device time of the kernels launched
inside each is summed (``layer["marks"]``). The graphed frames' metrics
do not see that frame. A program without the marks gives no sums."""

from __future__ import annotations

import sys

import numpy as np

from rtbench.harness import common
from rtbench.loops import frame

BLOCK = 8
CORNERS = ((0.001, 0.001), (0.999, 0.999), (0.001, 0.999), (0.999, 0.001))
MARKS = ("area_light", "csg_filter")


class Cell(frame.Cell):
    def trace(self):
        layer, bd = super().trace()
        layer["marks"] = marked_frame(self.scene, self.camera, self.device,
                                      self.frames[-1])
        return layer, bd

    def check(self, limits):
        """Every distinct frame of the window against the reference: the
        worst frame's ``px_off_hard`` and ``block_gap``."""
        want = reference_frame(self.desc, self.seed, self.device)
        band = noise_band(self.desc, self.device)
        frames = {f.tobytes(): f for f in self.frames}.values()
        hard = max(px_off_hard(f, want, band) for f in frames)
        gap = max(block_gap(f, want) for f in frames)
        return {"px_off_hard": common.check(hard, limits["px_off_hard"]),
                "block_gap": common.check(gap, limits["block_gap"])}


def reference_frame(desc, seed, device, dtype=None):
    """The reference's frame under random jitter seeded with ``seed``, in
    ``dtype`` (float32 where None)."""
    import torch

    from rtbench.reference import csg_area

    dtype = torch.float32 if dtype is None else dtype
    return csg_area.render_u8(csg_area.Scene(desc, device=device,
                                             dtype=dtype, seed=seed))


def noise_band(desc, device):
    """The pixels [v, h] that differ among the reference's four frames
    with constant corner jitter (:data:`CORNERS`)."""
    from rtbench.reference import csg_area

    corners = np.stack([csg_area.render_u8(csg_area.Scene(
        desc, device=device, jitter=c)) for c in CORNERS]).astype(np.int16)
    return (corners.max(0) != corners.min(0)).any(-1)


def px_off_hard(got, want, band):
    """The share of pixels outside ``band`` with a channel more than one
    step from ``want``'s (1 where the shapes differ)."""
    if got.shape != want.shape:
        return 1.0
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(-1)
    return float(((diff > 1) & ~band).mean())


def block_means(img, block=BLOCK):
    """The mean of each channel over ``block`` x ``block`` pixel blocks
    [ceil(v / block), ceil(h / block), 3] (float64)."""
    v, h = img.shape[:2]
    rows = np.add.reduceat(img.astype(np.float64), np.arange(0, v, block), 0)
    sums = np.add.reduceat(rows, np.arange(0, h, block), 1)
    counts = np.outer(np.diff(np.append(np.arange(0, v, block), v)),
                      np.diff(np.append(np.arange(0, h, block), h)))
    return sums / counts[..., None]


def block_gap(got, want):
    """The largest absolute difference, in u8 steps, of the two frames'
    means over 8 x 8 blocks (255 where the shapes differ)."""
    if got.shape != want.shape:
        return 255.0
    return float(np.abs(block_means(got) - block_means(want)).max())


def marked_frame(scene, camera, device, graphed):
    """One ``graphs=False`` frame under a profiler of its own: the
    device microseconds of the kernels launched inside each stage mark
    (summed over its ranges) and the ranges, by mark, with the whole
    frame's device microseconds under ``"frame"``. A program without the
    marks gives ``"frame"`` alone. Says on stderr whether the frame
    equals the graphed frame ``graphed``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.core.render import render

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        img = render(scene, camera, quantize=True, graphs=False)
    out = {}
    total = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            # a mark shows on the device's timeline too: it is no work
            if e.name not in MARKS:
                total += e.self_device_time_total
        elif e.name in MARKS:
            m = out.setdefault(e.name, dict(us=0.0, count=0))
            m["us"] += e.device_time_total
            m["count"] += 1
    out["frame"] = dict(us=total, count=1)
    print(f"marked frame: equal to the graphed frame "
          f"{np.array_equal(img, graphed)}; "
          + ", ".join(f"{k} {v['us'] / 1e3:.3f} ms over {v['count']}"
                      for k, v in out.items()), file=sys.stderr)
    return out
