#!/usr/bin/env python3
"""Drive raytracer_tpu_torch on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits non-zero before the final line):

1. device: the card's name and power limit; build the kernels (K1 and its
   pre-pass K1b) from raytracer_tpu_torch/csrc with nvcc for sm_90a and
   print ptxas' report.
2. kernel vs plain on the card: random soups (70, 700 triangles), a
   20,000-triangle 3-supergroup stream with mixed caps and any-hit,
   reversed rays, per-triangle det thresholds, the stream at 256 rays (the
   most slices per subtile) and 16,384 rays in all three modes, an exact
   tie (one triangle at three indices in three supergroups: the lowest
   index must win on every hit), any-hit shadow rays starting inside chunk
   boxes, a mesh whose last supergroup is mostly padding, and every K1
   call of one dragons_equiv tile and one glass_mesh tile at the main
   path's shapes (each call's width and gated tests per ray are logged:
   the packed deep levels make calls narrower than the tile, and at least
   one must be). t to rtol 1e-5, triangle index on >= 99.9% of hits
   (100% for the tie), hit existence and any-hit verdicts exact. The
   pre-pass kernel is held exactly against its torch version on every case
   (ids, counts and entries; the largest difference is reported).
3. oracle: the default world's ray (0,0,-5)->+z shades to
   (0.38066, 0.47583, 0.2855) within 1e-4.
4. device vs host: glass_mesh(instances=4) at 96x54 rendered on cuda and on
   the CPU; at most 0.5% of pixels more than one u8 step apart.
5. full width (the main path, launch counters zeroed just before it):
   dragons_equiv() 1200x480 (1,061,760 triangles), glass_mesh() 640x360,
   flagship() 1280x720, all depth 4: one warm-up frame, the median of 3
   timed frames, K1 launches per frame by mode, peak device memory, one
   PPM each. Then, for the busiest K1 call of each mode of a mid-frame
   tile (CUDA events): the call's time, its kernel's and its pre-pass's
   (kernel and torch) times, the CTAs launched and slices chosen, the
   gated ray x triangle tests per ray, warp and block (from the plain
   version), the bound and its share, the plain version's time. Then one
   dragons frame under torch.profiler (device busy and idle share, top
   kernels).
6. the CLI path (launch counters zeroed again just before its frames):
   ``python3 -m raytracer_tpu_torch --scene benchmarks/dragons_equiv.yaml
   --obj teapot.obj`` once as a subprocess (teapot.obj written by
   scenes.write_obj: the generated mesh), which must give a 1200x480 PPM;
   then in process, parse_scene (YAML + OBJ + build) timed once and the
   frames timed as in phase 5 for three YAML scenes: cli_dragons (held
   against phase 5's dragons frame, <= 0.5% of pixels more than one step
   apart), cli_csg_area_light (scenes.CSG_AREA_YAML: CSG x a 10x10 area
   light, 640x360) and cli_soft_glass (scenes.SOFT_GLASS_YAML: 353,920
   glass triangles under a 10x10 area light, 640x360). Then every K1 call
   of one soft_glass tile; its widest any-hit call (tile x 100 samples)
   launched whole, its outputs held against the plain version in
   65,536-ray blocks (every block), its pre-pass against the torch
   version, and the call timed. Then a --ppm + --dithering bayer4 earth
   scene through main(),
   and the two area-light scenes cut small on cuda against the CPU in
   deterministic jitter mode.

7. the differentiable path (launch counters zeroed again just before it):
   (7a) scenes.mesh_grad (6,320 triangles, a plane, a sphere; 64x48,
   depth 2): opaque, the image MSE over the eye position through the
   differentiable camera; glass, render_loss_and_grad over partition_scene's
   default surface. Each on cuda against the CPU (loss to rtol 1e-5, every
   gradient table to rtol 1e-3, atol 1e-5), central differences on the
   card (the mesh's diffuse, the eye's y), and K1 launched by the backward
   pass (the remat recompute). (7b) train cells at 512x256 = 131,072 rays
   in render's block order, one warm-up step and 3 timed: glass_train
   (glass_mesh, 353,920 triangles) and flagship_train, train_step with
   n_micro=4, remat off (one more glass step with remat on), and
   dragons_pose (1,061,760 triangles, Adam on the eye position); s/step,
   rays/s fwd+bwd, peak memory, K1 launches per step by mode, the losses,
   which must fall. Every K1 call of each cell's warm-up step (32,768-ray
   microbatches at S = 32 slices per subtile for glass_train, 131,072 rays
   at S = 8 for dragons_pose) is recorded with its outputs, which are held
   against the plain version as in phase 2, in 65,536-ray blocks. (7c) one
   step of each cell under torch.profiler. Then
   ``raytracer_tpu_torch.examples.inverse_render --pose`` on the card.
8. packed levels, resumable and multi-process rendering, the examples
   (launch counters zeroed again just before it, and read just after 8d):
   (8a) one dragons_equiv tile and one glass_mesh tile, each packed
   level's live share and width (render.color_at compacts the live rays
   of levels 1 to 4 to R/16, R/4, R/2 or R rows). (8b)
   utils.render_resumable on dragons_equiv 1200x480, stopped after half
   its tiles by an exception from a RenderStats hook, then resumed: the u8
   frame against phase 5's (0.5% budget), rays/s of both parts, any retry
   a failure. (8c) NCCL at world size 1 (a localhost TCP store):
   parallel.render_sharded on dragons_equiv, one warm-up call then one
   timed, against render; one make_sharded_train_step step on
   glass_train's 131,072-ray batch against train_step (loss to rtol 1e-5,
   tables to rtol 1e-4), the group torn down. (8d) examples basic_scene,
   csg and hexagon at 1280x720 as subprocesses on the card: each a
   well-formed P3 PPM, timed. Then, their K1 launches kept out of the
   kernels line: 8a's level-2 inputs through _packed_shade_level and
   shade_level, timed with CUDA events, the outputs equal once
   un-permuted; each scene's whole frame with packing off and on in turns
   (off, on, on, off; host clock), the u8 frames compared; one
   glass_train and one dragons_pose step of phase 7 with packing off and
   on in turns, each with its peak device memory and, from one more step
   under torch.profiler, its device busy time.

The last three lines of standard output: the card's name and power limit,
one JSON object with the kernels' numbers (launches: the main-path runs
of phases 5 to 8), and
the device JSON object.
Imports nothing of JAX or of the JAX package. The phase-2 cases come from
raytracer_tpu_torch/mesh_cases.py, which tests/test_torch_*.py use too.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
MT_FLOPS = 50          # f32 operations of one ray x triangle test (about)
PLAIN_BLOCK = 65536    # rays per block of the plain version in k1_numbers


LOG = []     # the open log file of main's --out directory, once opened


def log(*a):
    print(*a, flush=True)
    for f in LOG:
        print(*a, file=f, flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Recorder:
    """Wraps ops.mesh_cuda.mesh_nearest (as intersect and MeshNearest call
    it) and keeps a copy of every call's arguments (and, with
    ``outputs=True``, of its outputs as numpy t, idx, u, v under "k");
    the calls still go through."""

    def __init__(self, mc, outputs=False):
        self.mc = mc
        self.outputs = outputs
        self.calls = []

    def __enter__(self):
        self.orig = self.mc.mesh_nearest
        self.mc.mesh_nearest = self
        return self

    def __exit__(self, *exc):
        self.mc.mesh_nearest = self.orig

    def __call__(self, o, d, planes, bb, **kw):
        t = kw.get("t_init")
        call = dict(
            o=o.detach().clone(), d=d.detach().clone(), planes=planes, bb=bb,
            t_init=None if t is None else t.detach().clone(),
            any_hit=kw.get("any_hit", False), reverse=kw.get("reverse", False))
        self.calls.append(call)
        out = self.orig(o, d, planes, bb, **kw)
        if self.outputs:
            call["k"] = [x.cpu().numpy() for x in out]
        return out


def mode_of(call):
    return ("behind" if call["reverse"]
            else "any_hit" if call["any_hit"] else "nearest")


def check_prepass(mc, call, label):
    """K1b's kernel against its torch version on one call: ids, counts and
    entries exactly equal. Returns the largest of max |ent_kernel -
    ent_torch| over the entries finite in both and the numbers of ids,
    counts and entries that differ."""
    import torch

    d = -call["d"] if call["reverse"] else call["d"]
    inv = mc.inverse_dirs(d)
    before = mc.live_supergroups.launches
    k = mc.live_supergroups(call["o"], inv, call["bb"][1], call["t_init"])
    if mc.live_supergroups.launches != before + 1:
        raise AssertionError(f"{label}: pre-pass kernel not launched")
    p = mc.live_supergroups_plain(call["o"], inv, call["bb"][1],
                                  call["t_init"])
    both = torch.isfinite(k[2]) & torch.isfinite(p[2])
    ent_err = float((k[2] - p[2])[both].abs().max()) if bool(both.any()) \
        else 0.0
    differ = {name: int((x != y).sum())
              for name, x, y in zip(("ids", "cnt", "ent"), k, p)}
    for name, n in differ.items():
        if n:
            raise AssertionError(f"{label}: pre-pass {name} differs on "
                                 f"{n} entries")
    return max(ent_err, *map(float, differ.values()))


def check_kernel_vs_plain(mc, call, label, idx_min=0.999):
    """K1 against its plain version on one call's inputs (and the pre-pass
    kernel against its torch version); returns (the max |t_kernel -
    t_plain| over hits, check_prepass's number)."""
    pre_err = check_prepass(mc, call, label)
    k = [x.cpu().numpy() for x in mc.mesh_nearest(
        call["o"], call["d"], call["planes"], call["bb"],
        t_init=call["t_init"], any_hit=call["any_hit"],
        reverse=call["reverse"])]
    return compare_to_plain(mc, call, k, label, idx_min), pre_err


def compare_to_plain(mc, call, k, label, idx_min=0.999):
    """K1's outputs ``k`` (numpy t, idx, u, v) for a call's rays against
    the plain version on the same inputs: hit existence and any-hit verdicts
    exact, t to rtol 1e-5, triangle index on >= idx_min of hits. Returns
    the max |t_kernel - t_plain| over hits."""
    import numpy as np

    args = (call["o"], call["d"], call["planes"], call["bb"])
    kw = dict(t_init=call["t_init"], any_hit=call["any_hit"],
              reverse=call["reverse"])
    p = [x.cpu().numpy() for x in mc.mesh_nearest_plain(*args, **kw)]
    hit = np.isfinite(p[0])
    if not (np.isfinite(k[0]) == hit).all():
        raise AssertionError(f"{label}: hit existence differs on "
                             f"{int((np.isfinite(k[0]) != hit).sum())} rays")
    err = float(np.abs(k[0][hit] - p[0][hit]).max()) if hit.any() else 0.0
    np.testing.assert_allclose(k[0][hit], p[0][hit], rtol=1e-5, atol=1e-8,
                               err_msg=label)
    idx_ok = 1.0
    if call["any_hit"]:
        if not (k[0][hit] == 0.0).all():
            raise AssertionError(f"{label}: any-hit t is not 0 on a hit")
    elif hit.any():
        idx_ok = float((k[1][hit] == p[1][hit]).mean())
        if idx_ok < idx_min:
            raise AssertionError(f"{label}: triangle index agrees on only "
                                 f"{idx_ok:.4%} of hits")
    log(f"  {label:<34} mode={mode_of(call):<8} rays={call['o'].shape[0]:>6}"
        f" hits={int(hit.sum()):>6} max|dt|={err:.3g} idx_agree={idx_ok:.5f}")
    return err


def compare_blocks(mc, call, k, label):
    """compare_to_plain over a whole call's outputs ``k``, the plain
    version run in PLAIN_BLOCK-ray blocks (its [rays, CHUNK] tables would
    not fit at a million rays), every block checked. Returns the max
    |t_kernel - t_plain| over hits."""
    err = 0.0
    for b0 in range(0, call["o"].shape[0], PLAIN_BLOCK):
        sl = slice(b0, b0 + PLAIN_BLOCK)
        cut = dict(call, o=call["o"][sl], d=call["d"][sl],
                   t_init=None if call["t_init"] is None
                   else call["t_init"][sl])
        err = max(err, compare_to_plain(mc, cut, [x[sl] for x in k],
                                        f"{label}, rays {b0}+"))
    return err


def soup_cases(mc, dev):
    """The cases of tests/test_pallas.py, as mesh_nearest calls."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.mesh_cases import (
        inside_boxes_case, padding_case, stream_case, tie_case)

    def call(p1, e1, e2, o, d, det_eps=None, **kw):
        tri, bb = mc.pack_tri_planes_np(p1, e1, e2, det_eps)
        as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),  # noqa: E731
                                         device=dev)
        t0 = kw.pop("t_init", None)
        return dict(o=as_t(o), d=as_t(d), planes=as_t(tri),
                    bb=(as_t(bb[0]), as_t(bb[1])),
                    t_init=None if t0 is None else as_t(t0),
                    any_hit=kw.get("any_hit", False),
                    reverse=kw.get("reverse", False))

    def rays(rng, n, center, aim, spread=1.0, sd=1.0):
        o = rng.uniform(-spread, spread, (n, 3)) + np.asarray(center)
        d = rng.normal(0, sd, (n, 3)) + np.asarray(aim)
        return o, d / np.linalg.norm(d, axis=-1, keepdims=True)

    out = []
    for nt in (70, 700):
        rng = np.random.default_rng(1)
        p1 = rng.uniform(-3, 3, (nt, 3))
        e1, e2 = rng.normal(0, 0.5, (nt, 3)), rng.normal(0, 0.5, (nt, 3))
        o, d = rays(rng, 1024, (0, 0, -8.0), (0, 0, 3.0))
        out.append((f"soup nt={nt}", call(p1, e1, e2, o, d)))

    rng = np.random.default_rng(9)
    nt = 20000
    c = rng.uniform(-3, 3, (nt, 3))
    c[:, 2] = np.sort(rng.uniform(0, 30, nt))
    p1 = c + rng.normal(0, 0.1, (nt, 3))
    e1, e2 = rng.normal(0, 0.2, (nt, 3)), rng.normal(0, 0.2, (nt, 3))
    o, d = rays(rng, 1024, (0, 0, -5.0), (0, 0, 1.0), spread=2.0, sd=0.15)
    o[:, 2] = -5.0
    base = call(p1, e1, e2, o, d)
    t_ref = mc.mesh_nearest_plain(base["o"], base["d"], base["planes"],
                                  base["bb"])[0].cpu().numpy()
    cap = np.where(np.isfinite(t_ref), t_ref, 40.0)
    cap[0::2] *= 0.5
    cap[1::2] *= 1.5
    cap[2::8] = np.inf
    out += [
        ("stream 20k", base),
        ("stream 20k capped", call(p1, e1, e2, o, d, t_init=cap)),
        ("stream 20k any-hit capped",
         call(p1, e1, e2, o, d, t_init=cap, any_hit=True)),
        ("stream 20k any-hit", call(p1, e1, e2, o, d, any_hit=True)),
    ]

    rng = np.random.default_rng(3)
    p1 = rng.uniform(-3, 3, (700, 3))
    e1, e2 = rng.normal(0, 0.5, (700, 3)), rng.normal(0, 0.5, (700, 3))
    o = rng.uniform(-2, 2, (1024, 3))
    d = rng.normal(0, 1, (1024, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out.append(("reversed rays", call(p1, e1, e2, o, d, reverse=True)))

    rng = np.random.default_rng(3)
    p1 = rng.uniform(-0.02, 0.02, (70, 3))
    e1, e2 = rng.normal(0, 0.004, (70, 3)), rng.normal(0, 0.004, (70, 3))
    o = rng.uniform(-0.01, 0.01, (1024, 3)) + np.array([0, 0, -1.0])
    d = np.tile([0.0, 0.0, 1.0], (1024, 1))
    out.append(("per-triangle det_eps",
                call(p1, e1, e2, o, d, det_eps=np.full(70, 1e-12))))

    def case(c, **kw):
        return call(c["p1"], c["e1"], c["e2"], c["o"], c["d"],
                    t_init=c.get("t_init"), **kw)

    for r in (256, 16384):
        s = stream_case(r)
        out += [(f"stream {r} rays nearest", case(s)),
                (f"stream {r} rays any-hit", case(s, any_hit=True)),
                (f"stream {r} rays behind", case(s, reverse=True))]
    tie = case(tie_case())
    tie["idx_min"] = 1.0
    out += [("exact tie x3", tie),
            ("any-hit from inside boxes",
             case(inside_boxes_case(), any_hit=True)),
            ("padding: rays through", case(padding_case(True))),
            ("padding: rays away", case(padding_case(False)))]
    return out


def record_tile(scene, cam):
    """Every K1 call of the middle tile's color_at, with copies of its
    inputs."""
    import torch

    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.ops import mesh_cuda as MC

    tile = min(R.pick_tile_rays(scene.static), cam.hsize * cam.vsize)
    _, idx_tiles = R._order_tiles(cam.vsize, cam.hsize, tile, scene.device)
    inv, consts = R.camera_consts(cam, scene.device)
    with torch.no_grad(), Recorder(MC) as rec:
        o, d = R.tile_rays(inv, consts, idx_tiles[len(idx_tiles) // 2],
                           cam.hsize)
        R.color_at(scene, o, d)
    return rec.calls


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def live_work(mc, call):
    """Live (subtile, supergroup) pairs of a call's pre-pass."""
    d = -call["d"] if call["reverse"] else call["d"]
    return int(mc.live_supergroups(call["o"], mc.inverse_dirs(d),
                                   call["bb"][1], call["t_init"])[1].sum())


def profile_run(fn, s_unprofiled):
    """One call of ``fn`` under torch.profiler: device busy time (the sum
    of the device-side kernel events), its idle share against the
    un-profiled time of the same call, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: the aten ops that launch them carry the
    # same device time again
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kern)
    kern.sort(key=lambda e: -e.self_device_time_total)
    return dict(
        profiled_wall_s=wall, device_busy_s=busy_us / 1e6 if kern else None,
        device_idle_share=(1 - busy_us / 1e6 / s_unprofiled) if kern
        else None,
        n_device_ops=sum(e.count for e in kern),
        top=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                  count=e.count) for e in kern[:8]],
    )


def k1_numbers(mc, call, reps):
    """One mesh_nearest call's numbers: its time (pre-pass + kernel, CUDA
    events), the kernel's and the pre-pass's (kernel and torch) times, the
    CTAs, the plain version's time and gate counts, and the bound."""
    import torch

    args = (call["o"], call["d"], call["planes"], call["bb"])
    kw = dict(t_init=call["t_init"], any_hit=call["any_hit"],
              reverse=call["reverse"])
    o, planes, (bb_chunk, bb_super) = call["o"], call["planes"], call["bb"]
    r = o.shape[0]
    d = -call["d"] if call["reverse"] else call["d"]
    inv = mc.inverse_dirs(d)
    cap = (torch.full((r,), float("inf"), device=o.device)
           if call["t_init"] is None else call["t_init"])
    ids, cnt, ent = mc.live_supergroups(o, inv, bb_super, call["t_init"])
    mode = mode_of(call)

    def walk():
        return mc._walk(o, d, inv, cap, ids, cnt, ent, planes, bb_chunk,
                        call["any_hit"], mode)

    res = {}
    res["ms"] = cuda_ms(lambda: mc.mesh_nearest(*args, **kw), reps)
    res["kernel_ms"] = cuda_ms(walk, reps)
    res["prepass_ms"] = cuda_ms(
        lambda: mc.live_supergroups(o, inv, bb_super, call["t_init"]), reps)
    res["prepass_torch_ms"] = cuda_ms(
        lambda: mc.live_supergroups_plain(o, inv, bb_super, call["t_init"]),
        reps)
    res["prepass_torch_share"] = res["prepass_torch_ms"] / (
        res["prepass_torch_ms"] + res["kernel_ms"])
    n_sub = r // mc.RT
    res["slices"] = mc.walk_slices(r)
    res["ctas"] = n_sub * res["slices"]
    # the plain version in blocks of at most PLAIN_BLOCK rays (its
    # [rays, CHUNK] tables would not fit at a million rays); its time and
    # its gated test counts are the blocks' sums
    res["plain_ms"] = 0.0
    tests = {"ray": 0, "warp": 0, "block": 0}
    for b0 in range(0, r, PLAIN_BLOCK):
        sl = slice(b0, b0 + PLAIN_BLOCK)
        bargs = (o[sl], call["d"][sl], planes, call["bb"])
        bkw = dict(kw, t_init=None if call["t_init"] is None
                   else call["t_init"][sl])
        res["plain_ms"] += cuda_ms(
            lambda: mc.mesh_nearest_plain(*bargs, **bkw), 1)
        *_, bt = mc.mesh_nearest_plain(*bargs, **bkw, count_tests=True)
        for k in tests:
            tests[k] += bt[k]
    # bytes: the planes of every supergroup live for some subtile, read
    # once, plus the rays (o, d, cap) and the outputs (t, idx, u, v)
    listed = (torch.arange(ids.shape[1], device=ids.device)[None]
              < cnt[:, None])
    live = torch.zeros(ids.shape[1], dtype=torch.bool, device=ids.device)
    live[ids[listed].long()] = True
    n_live = int(live.sum())
    plane_bytes = n_live * mc.SG * mc.N_PLANES * mc.CHUNK * 4
    nbytes = plane_bytes + r * (24 + 4) + r * 16
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = MT_FLOPS * tests["ray"] / PEAK_F32_FLOPS * 1e3
    res.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               gated_tests=tests, live_supergroups=n_live, bytes=nbytes,
               rays=r)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["kernel_bound_share"] = res["bound_ms"] / res["kernel_ms"]
    # K1b alone: rays (o, inv, cap) and boxes in, lists out; about 20
    # operations per ray x supergroup slab test
    ns = bb_super.shape[1]
    pb = r * 28 + bb_super.numel() * 4 + n_sub * (8 * ns + 4)
    po = 20 * r * ns
    res["prepass_bound_ms"] = max(pb / PEAK_BYTES_PER_S, po / PEAK_F32_FLOPS) * 1e3
    res["prepass_bound_by"] = ("bytes" if pb / PEAK_BYTES_PER_S
                               >= po / PEAK_F32_FLOPS else "operations")
    return res


def frame(scene, cam, label, out_dir, mc):
    """Warm-up + median of 3 frames of render(); returns (numbers, the
    last u8 frame)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.canvas import to_p6_bytes
    from raytracer_tpu_torch.core.render import render

    render(scene, cam, quantize=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(mc.mesh_nearest.launches_by_mode)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        img = render(scene, cam, quantize=True)
        times.append(time.perf_counter() - t0)
    per_frame = {k: (mc.mesh_nearest.launches_by_mode[k] - before[k]) / 3
                 for k in before}
    if img.shape != (cam.vsize, cam.hsize, 3) or img.dtype != np.uint8:
        raise AssertionError(f"{label}: bad frame {img.shape} {img.dtype}")
    if not 0 < float(img.mean()) < 255:
        raise AssertionError(f"{label}: blank frame (mean {img.mean()})")
    (out_dir / f"{label}.ppm").write_bytes(to_p6_bytes(img))
    s = statistics.median(times)
    res = dict(s_per_frame=s, px_per_s=cam.hsize * cam.vsize / s,
               frame_times_s=times, k1_launches_per_frame=per_frame,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               triangles=scene.static.counts[5],
               resolution=f"{cam.hsize}x{cam.vsize}",
               mean_u8=float(img.mean()))
    log(f"  {label}: {json.dumps(res)}")
    return res, img

# the earth scene of tests/test_texture_scenes.py, at 160x100
EARTH_SCENE = """
- add: camera
  width: 160
  height: 100
  field-of-view: 0.8
  from: [1, 2, -10]
  to: [0, 1.1, 0]
  up: [0, 1, 0]
- add: point-light
  at: [-100, 100, -100]
  intensity: [1, 1, 1]
- add: plane
  material:
    color: [1, 1, 1]
    diffuse: 0.1
    specular: 0
    ambient: 0
    reflective: 0.4
- add: sphere
  transform:
    - [ rotate-y, 1.9 ]
    - [ translate, 0, 1.1, 0 ]
  material:
    pattern:
      kind: texture-map
      uv-mapping: spherical
      uv-pattern:
        kind: image
        ppm: earthmap.ppm
    diffuse: 0.9
    specular: 0.1
    shininess: 10
    ambient: 0.1
"""


def u8_diff(a, b, label, budget=0.005):
    """Pixels of two u8 frames more than one step apart; fails above the
    budget (a share of the pixels)."""
    import numpy as np

    diff = np.abs(a.astype(int) - b.astype(int)).max(-1)
    out = dict(differ=int((diff > 0).sum()), over_1_step=int((diff > 1).sum()),
               share_over_1_step=float((diff > 1).mean()),
               max_step=int(diff.max()))
    log(f"  {label}: {json.dumps(out)}")
    if out["share_over_1_step"] > budget:
        raise AssertionError(f"{label}: {out['share_over_1_step']:.4%} of "
                             f"pixels more than one step apart")
    return out


def same_tables(a, b):
    """Whether two scenes hold equal tables and static facts."""
    import torch

    from raytracer_tpu_torch.core.types import ARRAY_FIELDS

    if a.static != b.static:
        return False
    for k in ARRAY_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        if (x is None) != (y is None) or (x is not None and (
                x.shape != y.shape or not torch.equal(x, y))):
            return False
    return True


def cli_phase(mc, dev, out_dir, dragons, dragons_img):
    """Phase 6, the CLI path. Returns its numbers, its main-path launch
    counts and its largest kernel-vs-plain differences."""
    import numpy as np
    import torch

    from raytracer_tpu_torch import native, scenes
    from raytracer_tpu_torch.__main__ import main as cli_main
    from raytracer_tpu_torch.canvas import from_ppm_bytes
    from raytracer_tpu_torch.core.render import render
    from raytracer_tpu_torch.scene.yaml_scene import parse_scene

    log("[6] the CLI path")
    if not native.available():
        raise AssertionError("native I/O library unavailable: "
                             f"{native.unavailable_reason()}")
    teapot = out_dir / "teapot.obj"
    p, n, _ = scenes.revolved_mesh()
    scenes.write_obj(teapot, p, n)
    dragons_yaml = HERE / "benchmarks" / "dragons_equiv.yaml"
    cli_ppm = out_dir / "cli_dragons.ppm"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "--scene",
         str(dragons_yaml), "--obj", str(teapot), "--out", str(cli_ppm)],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    cli_img = from_ppm_bytes(cli_ppm.read_bytes())
    log(f"  CLI subprocess: rc 0, {cli_img.shape[1]}x{cli_img.shape[0]} "
        f"PPM, {cli_s:.1f} s (process start, build, parse, one frame, P3 "
        f"write)")

    sources = {
        "cli_dragons": (dragons_yaml.read_text(), [teapot]),
        "cli_csg_area_light": (scenes.CSG_AREA_YAML, []),
        "cli_soft_glass": (scenes.SOFT_GLASS_YAML, [teapot]),
    }
    mc.reset_launches()
    results, parsed, imgs = {}, {}, {}
    for label, (text, objs) in sources.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cam, scene = parse_scene(text, obj_files=[str(o) for o in objs],
                                 device=dev)
        torch.cuda.synchronize()
        parse_s = time.perf_counter() - t0
        results[label], imgs[label] = frame(scene, cam, label, out_dir, mc)
        results[label]["parse_build_s"] = parse_s
        parsed[label] = (cam, scene)
    launches = mc.mesh_nearest.launches
    by_mode = dict(mc.mesh_nearest.launches_by_mode)
    pre_launches = mc.live_supergroups.launches
    log(f"  K1 launches on the CLI path: {launches} {by_mode}; K1b "
        f"launches: {pre_launches}")
    if results["cli_soft_glass"]["k1_launches_per_frame"]["any_hit"] == 0:
        raise AssertionError("soft_glass launched no any-hit K1 call")

    cam = parsed["cli_dragons"][0]
    if cli_img.shape != (cam.vsize, cam.hsize, 3):     # 1200x480
        raise AssertionError(f"CLI frame shape {cli_img.shape}")
    out = {"cli_subprocess_s": cli_s}
    out["cli_dragons_vs_phase5"] = u8_diff(
        imgs["cli_dragons"], dragons_img, "cli_dragons vs phase 5 dragons")
    out["cli_dragons_vs_subprocess"] = u8_diff(
        imgs["cli_dragons"],
        np.floor(cli_img * 255.0 + 0.5).astype(np.uint8),
        "cli_dragons in process vs the CLI subprocess")
    out["cli_dragons_tables_equal_phase5"] = same_tables(
        parsed["cli_dragons"][1], dragons)
    log(f"  cli_dragons tables equal phase 5's: "
        f"{out['cli_dragons_tables_equal_phase5']}")

    # the widest K1 call of each frame, and soft_glass's any-hit call
    max_err = pre_err = 0.0
    timing = {}
    for label, (cam, scene) in parsed.items():
        calls = record_tile(scene, cam)
        results[label]["widest_k1_rays"] = max(
            (c["o"].shape[0] for c in calls), default=0)
        if label != "cli_soft_glass":
            continue
        wide = max((c for c in calls if c["any_hit"]),
                   key=lambda c: c["o"].shape[0])
        # the whole call at its own launch shape (S slices per subtile over
        # every subtile), held against the plain version block by block
        r = wide["o"].shape[0]
        pre_err = max(pre_err, check_prepass(mc, wide, "soft_glass area"))
        k = [x.cpu().numpy() for x in mc.mesh_nearest(
            wide["o"], wide["d"], wide["planes"], wide["bb"],
            t_init=wide["t_init"], any_hit=True, reverse=wide["reverse"])]
        log(f"  soft_glass any-hit area call: {r} rays, "
            f"{r // mc.RT * mc.walk_slices(r)} CTAs at S = "
            f"{mc.walk_slices(r)}; against plain in {PLAIN_BLOCK}-ray blocks")
        max_err = max(max_err, compare_blocks(mc, wide, k, "soft_glass area"))
        torch.cuda.reset_peak_memory_stats()
        timing["soft_glass:any_hit_area"] = k1_numbers(mc, wide, reps=3)
        timing["soft_glass:any_hit_area"]["max_memory_allocated"] = (
            torch.cuda.max_memory_allocated())
        log(f"  K1 soft_glass any-hit (area light): "
            f"{json.dumps(timing['soft_glass:any_hit_area'])}")

    for label in parsed:
        r = results[label]
        log(f"  {label}: {r['s_per_frame']:.4f} s/frame, parse + build "
            f"{r['parse_build_s']:.4f} s, K1 per frame "
            f"{r['k1_launches_per_frame']}, widest K1 call "
            f"{r['widest_k1_rays']} rays, peak {r['max_memory_allocated']} B")

    # --ppm + --dithering through main()
    tex = np.zeros((16, 32, 3), np.uint8)
    tex[:, :] = (20, 60, 200)
    tex[6:10, :] = (30, 180, 40)
    (out_dir / "earthmap.ppm").write_text(
        "P3\n32 16\n255\n" + " ".join(map(str, tex.reshape(-1))) + "\n")
    (out_dir / "earth.yaml").write_text(EARTH_SCENE)
    rc = cli_main(["--scene", str(out_dir / "earth.yaml"), "--ppm",
                   str(out_dir / "earthmap.ppm"), "--dithering", "bayer4",
                   "--out", str(out_dir / "cli_earth_bayer4.ppm")])
    earth = from_ppm_bytes((out_dir / "cli_earth_bayer4.ppm").read_bytes())
    if rc != 0 or earth.shape != (100, 160, 3) \
            or not set(np.unique(earth)) <= {0.0, 1.0} or earth.max() != 1.0:
        raise AssertionError(f"earth --ppm --dithering: rc {rc}, "
                             f"{earth.shape}, values {np.unique(earth)}")
    log(f"  earth --ppm --dithering bayer4 160x100: rc 0, black/white, "
        f"{float(earth.mean()):.4f} white")

    # device vs host, deterministic jitter, small
    for label, text, objs in (
            ("csg_area_light", scenes.csg_area_yaml(96, 54), []),
            ("soft_glass(4)", scenes.soft_glass_yaml(4, 96, 54),
             [str(teapot)])):
        frames = []
        for where in (dev, "cpu"):
            cam, scene = parse_scene(text, obj_files=objs, jitter=(0.5,),
                                     device=where)
            frames.append(render(scene, cam, quantize=True))
        out[f"{label}_cuda_vs_cpu"] = u8_diff(
            *frames, f"{label} 96x54 cuda vs cpu (jitter 0.5)")
    return dict(frames=results, checks=out, launches=launches,
                by_mode=by_mode, pre_launches=pre_launches, timing=timing,
                max_err=max_err, pre_err=pre_err)


# phase 7's sizes: the gradient scene's camera, and the train cells' ray
# batch (512x256 = 131,072 rays, the JAX package's train bench)
GRAD_SIZE = (64, 48)
TRAIN_SIZE = (512, 256)


def block_rays(cam, dev):
    """The camera's rays in render's 16x16-block order (each 256 rays one
    K1 subtile, a tight frustum) and that order."""
    import torch

    from raytracer_tpu_torch.camera import ray_grid
    from raytracer_tpu_torch.core.render import _block_order

    order = torch.as_tensor(_block_order(cam.vsize, cam.hsize, 16),
                            device=dev)
    o, d = ray_grid(cam, device=dev)
    return o[order].contiguous(), d[order].contiguous(), order


def eye_rays(cam, eye, order, to=None, up=None):
    """The camera's rays from ``eye`` (a tensor) towards ``to`` (default
    scenes.GRAD_TO, up scenes.GRAD_UP) through the differentiable camera,
    in ``order``."""
    import torch

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.camera import ray_grid_tensor, view_transform_tensor

    inv = torch.linalg.inv(view_transform_tensor(
        eye, scenes.GRAD_TO if to is None else to,
        scenes.GRAD_UP if up is None else up))
    o, d = ray_grid_tensor(inv, cam.hsize, cam.vsize, cam.field_of_view)
    return o[order], d[order]


def eye_loss_and_grads(mc, scene, cam, target, order, eye):
    """Image MSE of ``scene`` with rays from ``eye`` (remat on): (loss,
    {"eye": its gradient, the params' gradients}, K1 launches in the
    forward, K1 launches in the backward)."""
    import torch

    from raytracer_tpu_torch.parallel import partition_scene, render_loss

    params, recombine = partition_scene(scene)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    eye_t = torch.tensor(eye, device=scene.device, requires_grad=True)
    o, d = eye_rays(cam, eye_t, order)
    n0 = mc.mesh_nearest.launches
    loss = render_loss(leaves, recombine, o, d, target)
    n1 = mc.mesh_nearest.launches
    loss.backward()
    n2 = mc.mesh_nearest.launches
    grads = {"eye": eye_t.grad, **{
        k: torch.zeros_like(v) if v.grad is None else v.grad
        for k, v in leaves.items()}}
    return float(loss.detach()), grads, n1 - n0, n2 - n1


def card_vs_cpu(label, got, want):
    """(loss, grads) on the card against the CPU: loss to rtol 1e-5, every
    table to rtol 1e-3, atol 1e-5. Returns the largest |difference|."""
    import numpy as np

    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, err_msg=label)
    if set(got[1]) != set(want[1]):
        raise AssertionError(f"{label}: gradient keys differ")
    worst = 0.0
    for k, g in got[1].items():
        a, b = g.detach().cpu().numpy(), want[1][k].detach().cpu().numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite gradient of {k}")
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5,
                                   err_msg=f"{label}: {k}")
        if a.size:
            worst = max(worst, float(np.abs(a - b).max()))
    log(f"  {label}: loss {got[0]!r} (cpu {want[0]!r}), largest gradient "
        f"difference {worst:.3g} over {len(got[1])} tables")
    return worst


def grad_parity(mc, dev):
    """7a: the mesh_grad scene (6,320 triangles, a plane and a sphere,
    depth 2), opaque with the loss over the eye and glass with
    partition_scene's default surface: the card against the CPU, finite
    differences on the card, and K1 launched by the backward pass's
    recompute."""
    import numpy as np
    import torch

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.core.render import color_at
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss, render_loss_and_grad)
    from raytracer_tpu_torch.scene import build_scene

    out = {}
    h, v = GRAD_SIZE
    target_np = np.random.default_rng(0).uniform(0, 1, (h * v, 3)).astype(
        np.float32)
    for glass in (False, True):
        label = "glass" if glass else "opaque"
        items, cam = scenes.mesh_grad(glass, h, v)
        runs = {}
        for where in (dev, torch.device("cpu")):
            sc = build_scene(items, recursion_limit=2, device=where)
            target = torch.as_tensor(target_np, device=where)
            o, d, order = block_rays(cam, where)
            if glass:
                params, recombine = partition_scene(sc)
                n0 = mc.mesh_nearest.launches
                loss, grads = render_loss_and_grad(params, recombine, o, d,
                                                   target)
                n_all = mc.mesh_nearest.launches - n0
                with torch.no_grad():
                    render_loss(params, recombine, o, d, target)
                fwd = mc.mesh_nearest.launches - n0 - n_all
                runs[where.type] = (float(loss), grads, fwd, n_all - fwd)
            else:
                runs[where.type] = eye_loss_and_grads(
                    mc, sc, cam, target, order, scenes.GRAD_EYE)
            if where == dev:
                card = (sc, o, d, target, order, cam)
        k = runs[dev.type]
        res = dict(loss=k[0], k1_forward=k[2], k1_backward=k[3])
        log(f"  [7a] {label}: K1 launches forward {k[2]}, backward "
            f"(the remat recompute) {k[3]}")
        if k[3] <= 0:
            raise AssertionError(f"{label}: the backward pass launched no K1")
        res["max_grad_diff_vs_cpu"] = card_vs_cpu(
            f"[7a] {label} cuda vs cpu", k[:2], runs["cpu"][:2])

        sc, o, d, target, order, cam = card
        if glass:            # central differences on the mesh's diffuse
            params, recombine = partition_scene(sc)
            g = sc.static
            row = int(sc.mat_id[sum(g.counts[:5]) + int(sc.tri_tf_id[0])])
            eps = 1e-3

            def loss_at(delta):
                mat = params["mat"].clone()
                mat[row, 4] += delta
                with torch.no_grad():
                    img = color_at(recombine({**params, "mat": mat}), o, d)
                return float(torch.mean((img - target) ** 2))

            num = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
            ana = float(k[1]["mat"][row, 4])
            ok = abs(ana - num) < 5e-3 * max(1.0, abs(num))
            res["fd_mesh_diffuse"] = dict(analytic=ana, numeric=num)
        else:                # central differences on the eye's y
            eps = 1e-2

            def loss_at(delta):
                eye = torch.tensor(scenes.GRAD_EYE, device=dev)
                eye[1] += delta
                with torch.no_grad():
                    img = color_at(sc, *eye_rays(cam, eye, order))
                return float(torch.mean((img - target) ** 2))

            num = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
            ana = float(k[1]["eye"][1])
            ok = abs(ana - num) < max(0.3 * abs(num), 5e-3)
            res["fd_eye_y"] = dict(analytic=ana, numeric=num)
        log(f"  [7a] {label} finite differences: analytic {ana!r}, numeric "
            f"{num!r}")
        if not ok or ana == 0.0:
            raise AssertionError(f"{label}: gradient {ana} against finite "
                                 f"differences {num}")
        out[label] = res
    return out


def timed_steps(label, mc, step, state, n_rays):
    """One warm-up step, then 3 timed ones (host clock to a synchronize):
    s/step (median), rays/s fwd+bwd, peak device memory over the timed
    steps, K1 launches per step by mode and the loss of every step, which
    must fall from the first step to the last. Every K1 call of the
    warm-up step (the timed steps' shapes) is recorded with its outputs
    and held against the plain version (compare_blocks). Returns
    (numbers, state, the max |t_kernel - t_plain| over those calls)."""
    import torch

    losses = []
    with Recorder(mc, outputs=True) as rec:
        loss, state = step(state)
    losses.append(float(loss))
    max_err = 0.0
    for i, call in enumerate(rec.calls):
        max_err = max(max_err, compare_blocks(
            mc, call, call["k"], f"{label} call {i} (S = "
            f"{mc.walk_slices(call['o'].shape[0])})"))
    checked = dict(calls=len(rec.calls), max_abs_err=max_err, slices=sorted(
        {mc.walk_slices(c["o"].shape[0]) for c in rec.calls}))
    del rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(mc.mesh_nearest.launches_by_mode)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, state = step(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    s = statistics.median(times)
    res = dict(s_per_step=s, rays_per_s_fwd_bwd=n_rays / s,
               step_times_s=times, losses=losses, rays=n_rays,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               k1_launches_per_step={
                   k: (mc.mesh_nearest.launches_by_mode[k] - before[k]) / 3
                   for k in before},
               k1_checked_vs_plain=checked)
    log(f"  [7b] {label}: {json.dumps(res)}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    return res, state, max_err


def train_cells(mc, dev, dragons):
    """7b: glass_train and flagship_train (train_step, SGD lr 1e-3 against
    a black target, n_micro=4, remat off: the JAX package's train bench),
    one more glass step with remat on, and dragons_pose (Adam on the eye
    position against the frame from the true eye). Every batch is in
    render's block order. Returns (numbers, {cell: (its step, the state
    to step from)} for the profiles, the max |t_kernel - t_plain| over the
    warm-up steps' K1 calls)."""
    import torch

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.core.render import color_at
    from raytracer_tpu_torch.parallel import train_step
    from raytracer_tpu_torch.scene import build_scene

    h, v = TRAIN_SIZE
    out, runs, max_err = {}, {}, 0.0
    for label, (items, cam) in (
            ("glass_train", scenes.glass_mesh(56, h, v)),
            ("flagship_train", scenes.flagship(h, v))):
        sc = build_scene(items, device=dev)
        o, d, _ = block_rays(cam, dev)
        black = torch.zeros_like(o)

        def step(scene, o=o, d=d, black=black):
            return train_step(scene, o, d, black, lr=1e-3, n_micro=4,
                              remat=False)

        out[label], sc, e = timed_steps(label, mc, step, sc, o.shape[0])
        max_err = max(max_err, e)
        runs[label] = (step, sc)
        out[label].update(triangles=sc.static.counts[5],
                          resolution=f"{h}x{v}", n_micro=4, remat=False)
        if label == "glass_train":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = train_step(sc, o, d, black, lr=1e-3, n_micro=4,
                                 remat=True)
            torch.cuda.synchronize()
            out[label]["remat_step"] = dict(
                s=time.perf_counter() - t0, loss=float(loss),
                max_memory_allocated=torch.cuda.max_memory_allocated())
            log(f"  [7b] glass_train, one step with remat on: "
                f"{json.dumps(out[label]['remat_step'])}")

    # dragons_pose: the dragons_equiv scene (1,061,760 triangles) at 512x256
    _, cam = scenes.dragons_equiv(hsize=h, vsize=v)
    frm, to, up = (0.0, 2.5, -10.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)
    order = block_rays(cam, dev)[2]
    with torch.no_grad():
        target = color_at(dragons, *eye_rays(
            cam, torch.tensor(frm, device=dev), order, to, up))
    eye = torch.tensor(frm, device=dev) + torch.tensor(
        [0.1, -0.1, -0.1], device=dev)
    eye.requires_grad_(True)
    opt = torch.optim.Adam([eye], lr=0.03)
    grads = []

    def pose_step(_):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((color_at(dragons, *eye_rays(cam, eye, order, to,
                                                       up)) - target) ** 2)
        loss.backward()
        grads.append(eye.grad.detach().cpu().tolist())
        if not bool(torch.isfinite(eye.grad).all()):
            raise AssertionError(f"dragons_pose: gradient {eye.grad}")
        opt.step()
        return loss.detach(), None

    out["dragons_pose"], _, e = timed_steps("dragons_pose", mc, pose_step,
                                            None, h * v)
    out["dragons_pose"].update(triangles=dragons.static.counts[5],
                               resolution=f"{h}x{v}", eye_grads=list(grads),
                               eye=eye.detach().cpu().tolist())
    runs["dragons_pose"] = (pose_step, None)
    return out, runs, max(max_err, e)


def grad_phase(mc, dev, out_dir, dragons):
    """Phase 7, the differentiable path on the card (launch counters zeroed
    just before it). Its numbers keep each train cell's step and state
    under "runs", for phase 8's packing off/on steps."""
    from raytracer_tpu_torch.examples import inverse_render

    log("[7] the differentiable path (K1 launch counters zeroed)")
    mc.reset_launches()
    out = {"parity": grad_parity(mc, dev)}
    cells, runs, out["max_err"] = train_cells(mc, dev, dragons)
    out["cells"], out["runs"] = cells, runs
    for label, (step, state) in runs.items():
        cells[label]["profile"] = profile_run(
            lambda: step(state), cells[label]["s_per_step"])
        log(f"  [7c] one {label} step under torch.profiler: "
            f"{json.dumps(cells[label]['profile'])}")
    t0 = time.perf_counter()
    pose = inverse_render.main(["--pose"], log=lambda *a: None)
    out["inverse_render_pose"] = dict(
        s=time.perf_counter() - t0, error=pose["error"],
        translation=pose["translation"], first_loss=pose["losses"][0],
        last_loss=pose["losses"][-1], steps=len(pose["losses"]))
    log(f"  [7] examples/inverse_render --pose on the card: "
        f"{json.dumps(out['inverse_render_pose'])}")
    out["launches"] = mc.mesh_nearest.launches
    out["by_mode"] = dict(mc.mesh_nearest.launches_by_mode)
    out["pre_launches"] = mc.live_supergroups.launches
    log(f"  K1 launches on the differentiable path: {out['launches']} "
        f"{out['by_mode']}; K1b launches: {out['pre_launches']}")
    if out["by_mode"]["nearest"] == 0 or out["by_mode"]["behind"] == 0:
        raise AssertionError(f"phase 7 did not run K1 in nearest and "
                             f"behind modes: {out['by_mode']}")
    return out


def parked(out):
    """A level's outputs with its zero-weight spawns parked, as color_at
    parks them before the next level."""
    from raytracer_tpu_torch.core.render import park_rays

    colored, *spawns = out[:3]
    return [colored] + [x for so, sd, sw in spawns for x in (
        *park_rays(so, sd, (sw > 0.0).any(-1)), sw)]


def packed_levels(scene, cam, label):
    """8a: the middle tile's color_at, its packed levels recorded (live
    share and width of each). Returns (the numbers, each level's inputs
    and keywords)."""
    import torch

    from raytracer_tpu_torch.core import render as R

    levels = []
    real = R._packed_shade_level

    def spy(scene_, o, d, w, generator=None, **kw):
        levels.append(dict(o=o.detach().clone(), d=d.detach().clone(),
                           w=w.detach().clone(), **kw))
        return real(scene_, o, d, w, generator, **kw)

    tile = min(R.pick_tile_rays(scene.static), cam.hsize * cam.vsize)
    _, idx_tiles = R._order_tiles(cam.vsize, cam.hsize, tile, scene.device)
    inv, consts = R.camera_consts(cam, scene.device)
    R._packed_shade_level = spy
    try:
        with torch.no_grad():
            o, d = R.tile_rays(inv, consts, idx_tiles[len(idx_tiles) // 2],
                               cam.hsize)
            R.color_at(scene, o, d)
    finally:
        R._packed_shade_level = real
    res = dict(tile=tile, levels=[dict(
        level=i + 1, live=int((lv["w"] > 0).any(-1).sum()),
        live_share=float((lv["w"] > 0).any(-1).float().mean()),
        width=lv["width"]) for i, lv in enumerate(levels)])
    log(f"  [8a] {label} tile of {tile} rays, packed levels: "
        f"{json.dumps(res['levels'])}")
    if len(levels) < 2:
        raise AssertionError(f"{label}: the tile ran {len(levels)} packed "
                             f"levels, fewer than 2")
    return res, levels


def level2_timing(scene, label, res, levels):
    """8a, after the main path's counts are read: level 2's recorded
    inputs through _packed_shade_level (at the width color_at chose) and
    shade_level, timed with CUDA events, the outputs equal once
    un-permuted and parked."""
    import torch

    from raytracer_tpu_torch.core import render as R

    packed = R._packed_shade_level
    tile = res["tile"]
    lv = levels[1]                                   # level 2
    width = lv["width"]
    with torch.no_grad():
        full = parked(R.shade_level(scene, lv["o"], lv["d"], lv["w"]))
        out = packed(scene, lv["o"], lv["d"], lv["w"], thread_perm=True,
                   width=width)
        back = torch.argsort(out[3])
        got = [x[back] for x in parked(out)]
        differ = [int((a != b).any(-1).sum()) if a.dim() > 1
                  else int((a != b).sum()) for a, b in zip(got, full)]
        res["level2_rows_differing"] = differ
        if any(differ):
            raise AssertionError(f"{label}: packed level 2 differs from "
                                 f"the full-width level on {differ} rows")
        res["level2_packed_ms"] = cuda_ms(lambda: packed(
            scene, lv["o"], lv["d"], lv["w"], thread_perm=True,
            width=width), 5)
        res["level2_full_ms"] = cuda_ms(lambda: R.shade_level(
            scene, lv["o"], lv["d"], lv["w"]), 5)
    res["level2_width"] = width
    log(f"  [8a] {label} level 2 ({res['levels'][1]['live']} live of "
        f"{tile}, width {width}): packed {res['level2_packed_ms']:.3f} ms, "
        f"full width {res['level2_full_ms']:.3f} ms; outputs equal")
    return res


def packing_ab(scene, cam, label):
    """8a: whole frames with the packed levels off (render.packs forced
    False) and on, in turns (off, on, on, off) after one warm-up frame
    each; host clock to the u8 frame on the host. The frames must agree
    (0.5% budget; packing is exact, so 0 pixels are expected)."""
    import numpy as np

    from raytracer_tpu_torch.core import render as R

    real = R.packs
    times = {"packed": [], "unpacked": []}
    imgs = {}
    try:
        for mode in ("unpacked", "packed", "packed", "unpacked"):
            R.packs = real if mode == "packed" else (lambda st, r: False)
            if mode not in imgs:
                imgs[mode] = R.render(scene, cam, quantize=True)   # warm-up
            t0 = time.perf_counter()
            imgs[mode] = R.render(scene, cam, quantize=True)
            times[mode].append(time.perf_counter() - t0)
    finally:
        R.packs = real
    res = dict(frame_s=times, packed_over_unpacked=float(
        np.median(times["packed"]) / np.median(times["unpacked"])))
    res["frames"] = u8_diff(imgs["packed"], imgs["unpacked"],
                            f"[8a] {label} packed vs unpacked frame")
    log(f"  [8a] {label} frames, packing off/on in turns: {json.dumps(res)}")
    return res


def packing_steps(runs):
    """8a: one glass_train step and one dragons_pose step (phase 7's) with
    the packed levels off and on in turns (off, on, on, off): each turn a
    timed step (host clock to a synchronize) with its peak device memory,
    then one more step under torch.profiler for its device busy time."""
    import torch

    from raytracer_tpu_torch.core import render as R

    real = R.packs
    out = {}
    try:
        for label in ("glass_train", "dragons_pose"):
            step, state = runs[label]
            res = {m: dict(s=[], max_memory_allocated=[], device_busy_s=[])
                   for m in ("unpacked", "packed")}
            for mode in ("unpacked", "packed", "packed", "unpacked"):
                R.packs = real if mode == "packed" else (lambda st, r: False)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                step(state)
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                res[mode]["s"].append(s)
                res[mode]["max_memory_allocated"].append(
                    torch.cuda.max_memory_allocated())
                res[mode]["device_busy_s"].append(
                    profile_run(lambda: step(state), s)["device_busy_s"])
            out[label] = res
            log(f"  [8a] {label} steps, packing off/on in turns: "
                f"{json.dumps(res)}")
    finally:
        R.packs = real
    return out


class StopAfter(Exception):
    """Raised by HaltingStats to stop a render part way."""


def resumable_phase(out_dir, dragons, d_cam, dragons_img):
    """8b: render_resumable on dragons_equiv, stopped after half its tiles
    (a stats hook raises), then resumed; the u8 frame against phase 5's.
    Any retry fails the run."""
    import shutil

    import numpy as np

    from raytracer_tpu_torch.core.render import pick_tile_rays
    from raytracer_tpu_torch.utils import RenderStats, render_resumable

    tile = pick_tile_rays(dragons.static)
    n_tiles = -(-d_cam.hsize * d_cam.vsize // tile)

    class HaltingStats(RenderStats):
        def end_tile(self, n_rays):
            super().end_tile(n_rays)
            if self.tiles == n_tiles // 2:
                raise StopAfter

    def no_retry(ti, attempt, reason):
        raise AssertionError(f"resumable: tile {ti} retried: {reason}")

    ckpt = out_dir / "resumable_dragons"
    shutil.rmtree(ckpt, ignore_errors=True)
    first = HaltingStats()
    try:
        render_resumable(dragons, d_cam, ckpt, tile_rays=tile, stats=first,
                         on_retry=no_retry)
        raise AssertionError("resumable: the stats hook did not stop it")
    except StopAfter:
        pass
    rest = RenderStats()
    img = render_resumable(dragons, d_cam, ckpt, tile_rays=tile, stats=rest,
                           on_retry=no_retry)
    shutil.rmtree(ckpt, ignore_errors=True)
    if first.tiles + rest.tiles != n_tiles:
        raise AssertionError(f"resumable: {first.tiles} + {rest.tiles} "
                             f"tiles rendered, not {n_tiles}")
    u8 = np.floor(np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    res = dict(tiles=n_tiles, first_tiles=first.tiles,
               resumed_tiles=rest.tiles, first=first.summary(),
               resumed=rest.summary(),
               rays_per_sec_first=first.rays_per_sec,
               rays_per_sec_resumed=rest.rays_per_sec)
    res["vs_phase5"] = u8_diff(u8, dragons_img,
                               "[8b] resumed dragons_equiv vs phase 5")
    log(f"  [8b] render_resumable dragons_equiv: {json.dumps(res)}")
    return res


def sharded_phase(dev, dragons, d_cam):
    """8c: NCCL at world size 1 (a localhost TCP store): render_sharded on
    dragons_equiv against render, one make_sharded_train_step step on
    glass_train's batch against train_step, then the group torn down."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.core.render import render
    from raytracer_tpu_torch.parallel import (
        init_distributed, make_mesh, make_sharded_train_step,
        partition_scene, render_sharded, train_step)
    from raytracer_tpu_torch.scene import build_scene

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, device=dev)
    res = dict(rank_world=list(got), backend=dist.get_backend())
    try:
        mesh = make_mesh(dev.type)
        want = render(dragons, d_cam)
        t0 = time.perf_counter()
        render_sharded(dragons, d_cam, mesh)     # warm-up: NCCL's set-up
        res["sharded_warmup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = render_sharded(dragons, d_cam, mesh)
        res["sharded_s"] = time.perf_counter() - t0
        diff = np.abs(img - want)
        res["sharded_max_abs_diff"] = float(diff.max())
        res["sharded_pixels_differing"] = int((diff > 0).any(-1).sum())
        q = lambda x: np.floor(np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8)  # noqa: E731
        res["sharded_vs_render"] = u8_diff(
            q(img), q(want),
            f"[8c] render_sharded ({res['backend']}, 1 rank) vs render")

        h, v = TRAIN_SIZE
        items, cam = scenes.glass_mesh(56, h, v)
        sc = build_scene(items, device=dev)
        o, d, _ = block_rays(cam, dev)
        black = torch.zeros_like(o)
        step = make_sharded_train_step(mesh, lr=1e-3, n_micro=4, remat=False)
        step(sc, o, d, black)                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_s, new_s = step(sc, o, d, black)
        torch.cuda.synchronize()
        res["sharded_step_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss_1, new_1 = train_step(sc, o, d, black, lr=1e-3, n_micro=4,
                                   remat=False)
        torch.cuda.synchronize()
        res["train_step_s"] = time.perf_counter() - t0
        res["sharded_loss"], res["train_step_loss"] = float(loss_s), float(
            loss_1)
        np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-5,
                                   err_msg="sharded step loss")
        worst = 0.0
        a, _ = partition_scene(new_s)
        b, _ = partition_scene(new_1)
        for k in a:
            np.testing.assert_allclose(a[k].cpu().numpy(),
                                       b[k].cpu().numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
            if a[k].numel():
                worst = max(worst, float((a[k] - b[k]).abs().max()))
        res["step_tables_max_abs_diff"] = worst
    finally:
        dist.destroy_process_group()
    log(f"  [8c] world size 1: {json.dumps(res)}")
    return res


def example_runs(dev, out_dir):
    """8d: basic_scene, csg and hexagon at their default 1280x720 as
    subprocesses on the card; each must print a well-formed P3 PPM."""
    from raytracer_tpu_torch.canvas import from_ppm_bytes

    out = {}
    for name in ("basic_scene", "csg", "hexagon"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"raytracer_tpu_torch.examples.{name}",
             "--device", dev.type], cwd=HERE, capture_output=True,
            timeout=300)
        s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"example {name} exited {proc.returncode}:"
                                 f"\n{proc.stderr[-4000:].decode()}")
        img = from_ppm_bytes(proc.stdout)
        if proc.stdout[:2] != b"P3" or img.shape != (720, 1280, 3) \
                or not 0.0 < float(img.mean()) < 1.0:
            raise AssertionError(f"example {name}: not a 1280x720 P3 PPM "
                                 f"of a picture ({img.shape})")
        out[name] = dict(s=s, ppm_bytes=len(proc.stdout),
                         mean=float(img.mean()))
    log(f"  [8d] examples on {dev.type}: {json.dumps(out)}")
    return out


def phase8(mc, dev, out_dir, dragons, d_cam, glass, g_cam, dragons_img,
           runs):
    """Phase 8: packed levels, resumable, sharded and the examples. The
    launch counters are zeroed just before the main path's runs (the
    recorded tiles, 8b, 8c, 8d) and read just after them; the level-2
    timing and the packing off/on frames and steps run after that read,
    and their launches are reported apart (``side_launches``)."""
    log("[8] packed levels, resumable and sharded rendering, examples "
        "(K1 launch counters zeroed)")
    mc.reset_launches()
    scenes_ = (("dragons_equiv", dragons, d_cam), ("glass_mesh", glass, g_cam))
    recorded = {label: packed_levels(scene, cam, label)
                for label, scene, cam in scenes_}
    out = {"packed": {label: res for label, (res, _) in recorded.items()}}
    out["resumable"] = resumable_phase(out_dir, dragons, d_cam, dragons_img)
    out["sharded"] = sharded_phase(dev, dragons, d_cam)
    out["examples"] = example_runs(dev, out_dir)
    out["launches"] = mc.mesh_nearest.launches
    out["by_mode"] = dict(mc.mesh_nearest.launches_by_mode)
    out["pre_launches"] = mc.live_supergroups.launches
    log(f"  K1 launches on phase 8's main path: {out['launches']} "
        f"{out['by_mode']}; K1b launches: {out['pre_launches']}")
    if out["launches"] == 0:
        raise AssertionError("phase 8 launched no K1")

    for label, scene, cam in scenes_:
        res, levels = recorded[label]
        level2_timing(scene, label, res, levels)
        res["ab"] = packing_ab(scene, cam, label)
    out["packing_steps"] = packing_steps(runs)
    out["side_launches"] = mc.mesh_nearest.launches - out["launches"]
    log(f"  K1 launches of the level-2 timing and the packing off/on runs "
        f"(not in the kernels line): {out['side_launches']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(HERE / "build" / "chip_smoke"),
                    help="directory for the PPMs and the numbers")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (HERE / "raytracer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: raytracer_tpu_torch/ is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import numpy as np

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch import transforms as tf
    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.core.render import color_at, render
    from raytracer_tpu_torch.mesh_cases import TIE_INDEX
    from raytracer_tpu_torch.ops import mesh_cuda as MC
    from raytracer_tpu_torch.scene import build_scene, specs as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    LOG.append(open(out_dir / "chip_smoke.log", "w"))
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. device + build ------------------------------------------------
    smi = smi_line()
    log(f"[1] device: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path, build_log = MC.build_library()
    log(f"  built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "error")):
            log("  ptxas:", line.strip())

    # -- 2. kernel vs plain -------------------------------------------------
    log("[2] K1 kernel vs plain on the card")
    max_err = pre_err = 0.0
    for label, call in soup_cases(MC, dev):
        e, pe = check_kernel_vs_plain(MC, call, label,
                                      call.get("idx_min", 0.999))
        max_err, pre_err = max(max_err, e), max(pre_err, pe)
        if label == "exact tie x3":
            t, idx, _, _ = MC.mesh_nearest(call["o"], call["d"],
                                           call["planes"], call["bb"])
            if not (bool(torch.isfinite(t).all())
                    and bool((idx == TIE_INDEX).all())):
                raise AssertionError("exact tie: the lowest index did not "
                                     "win every ray")
    t0 = time.perf_counter()
    d_items, d_cam = scenes.dragons_equiv()
    dragons = build_scene(d_items, device=dev)
    log(f"  dragons_equiv built: {dragons.static.counts[5]} triangles, "
        f"{dragons.mesh_planes.shape[0]} supergroups, "
        f"{dragons.mesh_planes.numel() * 4 / 1e6:.1f} MB of planes, "
        f"{time.perf_counter() - t0:.1f} s")
    g_items, g_cam = scenes.glass_mesh()
    glass = build_scene(g_items, device=dev)
    d_calls = record_tile(dragons, d_cam)
    g_calls = record_tile(glass, g_cam)
    for label, calls, sc in (("dragons", d_calls, dragons),
                             ("glass", g_calls, glass)):
        widths = [c["o"].shape[0] for c in calls]
        tile = R.pick_tile_rays(sc.static)
        per_ray = []
        for c in calls:       # the gates' ray x triangle tests, per ray
            tests = MC.mesh_nearest_plain(
                c["o"], c["d"], c["planes"], c["bb"], t_init=c["t_init"],
                any_hit=c["any_hit"], reverse=c["reverse"],
                count_tests=True)[-1]
            per_ray.append(round(tests["ray"] / c["o"].shape[0], 1))
        log(f"  {label} tile of {tile} rays: K1 calls (mode, width, gated "
            f"tests per ray): {list(zip(map(mode_of, calls), widths, per_ray))}")
        if min(widths) >= tile:
            raise AssertionError(f"{label}: no K1 call narrower than the "
                                 f"tile (the packed levels)")
        for i, call in enumerate(calls):
            e, pe = check_kernel_vs_plain(MC, call, f"{label} tile call {i}")
            max_err, pre_err = max(max_err, e), max(pre_err, pe)
    log(f"  max |dt| over every case {max_err}; pre-pass kernel vs torch "
        f"{pre_err}")
    modes = {mode_of(c) for c in d_calls + g_calls}
    if modes != {"nearest", "any_hit", "behind"}:
        raise AssertionError(f"recorded tiles cover modes {modes}")

    # -- 3. oracle ----------------------------------------------------------
    world = build_scene([
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Sphere(material=S.Material(color=(0.8, 1.0, 0.6), diffuse=0.7,
                                     specular=0.2)),
        S.Sphere(transform=tf.scaling(0.5, 0.5, 0.5)),
    ], device=dev)
    with torch.no_grad():
        got = color_at(world, torch.tensor([[0.0, 0.0, -5.0]], device=dev),
                       torch.tensor([[0.0, 0.0, 1.0]], device=dev), 1)
    got = got[0].cpu().numpy()
    if not np.allclose(got, [0.38066, 0.47583, 0.2855], atol=1e-4):
        raise AssertionError(f"default-world oracle: {got}")
    log(f"[3] default-world oracle ok: {got.tolist()}")

    # -- 4. device vs host --------------------------------------------------
    items4, cam4 = scenes.glass_mesh(instances=4, hsize=96, vsize=54)
    img_gpu = render(build_scene(items4, device=dev), cam4, quantize=True)
    img_cpu = render(build_scene(items4, device="cpu"), cam4, quantize=True)
    diff = np.abs(img_gpu.astype(int) - img_cpu.astype(int)).max(-1)
    frac = float((diff > 1).mean())
    log(f"[4] glass_mesh(4) 96x54 cuda vs cpu: {int((diff > 0).sum())} "
        f"pixels differ, {frac:.4%} by more than 1 step, max {diff.max()}")
    if frac > 0.005:
        raise AssertionError(f"cuda vs cpu: {frac:.4%} of pixels > 1 step")

    # -- 5. full width: the main path ---------------------------------------
    log("[5] full-width frames (K1 launch counters zeroed)")
    MC.reset_launches()
    f_items, f_cam = scenes.flagship()
    results = {}
    results["dragons_equiv"], dragons_img = frame(
        dragons, d_cam, "dragons_equiv", out_dir, MC)
    results["glass_mesh"], _ = frame(glass, g_cam, "glass_mesh", out_dir, MC)
    results["flagship"], _ = frame(build_scene(f_items, device=dev), f_cam,
                                   "flagship", out_dir, MC)
    launches = MC.mesh_nearest.launches
    by_mode = dict(MC.mesh_nearest.launches_by_mode)
    pre_launches = MC.live_supergroups.launches
    log(f"  K1 launches on the main path: {launches} {by_mode}; "
        f"K1b launches: {pre_launches}")
    if pre_launches == 0:
        raise AssertionError("the pre-pass kernel was not launched")
    dl = results["dragons_equiv"]["k1_launches_per_frame"]
    gl = results["glass_mesh"]["k1_launches_per_frame"]
    if not (dl["nearest"] > 0 and dl["any_hit"] > 0 and gl["behind"] > 0):
        raise AssertionError(f"K1 not launched in every mode: dragons {dl}, "
                             f"glass {gl}")

    timing = {}
    for label, calls in (("dragons", d_calls), ("glass", g_calls)):
        for mode in ("nearest", "any_hit", "behind"):
            mine = [c for c in calls if mode_of(c) == mode]
            if mine:   # the tile's call of that mode with the most work
                busiest = max(mine, key=lambda c: live_work(MC, c))
                timing[f"{label}:{mode}"] = k1_numbers(MC, busiest, reps=10)
                log(f"  K1 {label} {mode}: {json.dumps(timing[label + ':' + mode])}")
    prof = profile_run(lambda: render(dragons, d_cam, quantize=True),
                       results["dragons_equiv"]["s_per_frame"])
    log(f"  dragons_equiv frame under torch.profiler: {json.dumps(prof)}")

    # -- 6. the CLI path ----------------------------------------------------
    cli = cli_phase(MC, dev, out_dir, dragons, dragons_img)
    results.update(cli["frames"])
    timing.update(cli["timing"])
    launches += cli["launches"]
    pre_launches += cli["pre_launches"]
    by_mode = {k: by_mode[k] + cli["by_mode"][k] for k in by_mode}
    max_err, pre_err = max(max_err, cli["max_err"]), max(pre_err,
                                                         cli["pre_err"])

    # -- 7. the differentiable path -----------------------------------------
    grad = grad_phase(MC, dev, out_dir, dragons)
    runs = grad.pop("runs")
    launches += grad.pop("launches")
    pre_launches += grad.pop("pre_launches")
    max_err = max(max_err, grad["max_err"])
    by_mode = {k: by_mode[k] + grad["by_mode"][k] for k in by_mode}

    # -- 8. packed levels, resumable and sharded rendering, examples ------
    p8 = phase8(MC, dev, out_dir, dragons, d_cam, glass, g_cam, dragons_img,
                runs)
    launches += p8.pop("launches")
    pre_launches += p8.pop("pre_launches")
    by_mode = {k: by_mode[k] + p8["by_mode"][k] for k in by_mode}
    main_k1 = timing["dragons:nearest"]
    kernels = [{
        "name": "mesh_nearest",
        "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/mesh_nearest.cu",
        "replaces": "raytracer_tpu/ops/mesh_pallas.py:393",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_k1["ms"],
        "plain_ms": main_k1["plain_ms"],
        "bound_ms": main_k1["bound_ms"],
        "bound_by": main_k1["bound_by"],
        "library_ms": None,
        "launches_by_mode": by_mode,
        "by_call": timing,
    }, {
        "name": "live_supergroups",
        "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/mesh_nearest.cu",
        "replaces": "raytracer_tpu/ops/mesh_pallas.py:305",
        "launches": pre_launches,
        "max_abs_err": pre_err,
        "ms": main_k1["prepass_ms"],
        "plain_ms": main_k1["prepass_torch_ms"],
        "bound_ms": main_k1["prepass_bound_ms"],
        "bound_by": main_k1["prepass_bound_by"],
        "library_ms": None,
    }]
    summary = dict(device=smi, frames=results, kernels=kernels,
                   dragons_profile=prof, cli_checks=cli["checks"], grad=grad,
                   phase8=p8, seconds=time.perf_counter() - t_start)
    (out_dir / "numbers.json").write_text(json.dumps(summary, indent=1))
    log(f"total {summary['seconds']:.1f} s")

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
