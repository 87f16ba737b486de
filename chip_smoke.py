#!/usr/bin/env python3
"""Drive raytracer_tpu_torch on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits non-zero before the final line):

1. device: the card's name and power limit; build the kernels (K1 and its
   pre-pass K1b, the tile graph's set_conditionals_kernel, and
   table_gather's forward kernel and the two routes of its backward) from
   raytracer_tpu_torch/csrc with nvcc for sm_90a, one nvcc per source,
   started together, and print ptxas' report; then, on a line of its own,
   the versions conditional graph nodes depend on (PyTorch, the CUDA it
   was built with, the runtime, the driver) and whether they are there.
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
   (ids, counts and entries; the largest difference is reported), and on
   boxes alone (mesh_cases.prepass_case: a subtile that misses
   everything, tied entries, origins inside a box) at 1, 7, 130, 300 and
   6,954 supergroups, capped and uncapped.
3. oracle: the default world's ray (0,0,-5)->+z shades to
   (0.38066, 0.47583, 0.2855) within 1e-4.
4. device vs host: glass_mesh(instances=4) at 96x54 rendered on cuda and on
   the CPU; at most 0.5% of pixels more than one u8 step apart.
5. full width (the main path, launch counters zeroed just before it):
   dragons_equiv() 1200x480 (1,061,760 triangles), glass_mesh() 640x360,
   flagship() 1280x720, all depth 4, through render's default path (one
   CUDA graph per tile, core/tile_program.py; the warm-up frame captures
   it): one warm-up frame, the median of 3 timed frames, K1 launches per
   frame by mode (counted from the level logs), table_gather's forward
   launches (which must not be 0), peak device memory, one
   PPM each. Then, for the busiest K1
   call of each mode of a mid-frame tile (CUDA events): the call's time,
   its kernel's and its pre-pass's (kernel and torch) times, the CTAs
   launched and slices chosen, the gated ray x triangle tests per ray,
   warp and block (from the plain version), the bound and its share, the
   plain version's time. Then one dragons frame under torch.profiler
   (device busy and idle share, top kernels, the host's runtime calls).
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

7. the differentiable path (launch counters zeroed again just before it,
   set_conditionals_kernel's too, and read at its end):
   (7a) scenes.mesh_grad (6,320 triangles, a plane, a sphere; 64x48,
   depth 2): opaque, the image MSE over the eye position through the
   differentiable camera; glass, render_loss_and_grad over partition_scene's
   default surface. Each on cuda against the CPU (loss to rtol 1e-5, every
   gradient table to rtol 1e-3, atol 1e-5), central differences on the
   card (the mesh's diffuse, the eye's y), and K1 launched by the backward
   pass (the remat recompute). (7b) train cells at 512x256 = 131,072 rays
   in render's block order, through the train program (a microbatch one
   forward and one backward CUDA graph launch, its levels skipped or
   packed on the card by conditional nodes, core/train_program.py, the
   default of every train entry point; the warm-up step captures every
   branch of every level, each run once eagerly first), one warm-up step
   and 3 timed: glass_train (glass_mesh, 353,920
   triangles) and flagship_train, train_step with n_micro=4, remat off
   (one more glass step with remat on, after a warm-up step), and
   dragons_pose (1,061,760 triangles, Adam on the eye position:
   render_loss_and_grad of rays that require grad, made from the eye by
   the differentiable camera, and no scene parameter); s/step, rays/s
   fwd+bwd, peak memory, K1 launches per step by mode, the losses, which
   must fall, and (G, K, indices, dtype, differentiated) of every
   table_gather call of glass_train's and flagship_train's first step. Every K1 call of each cell's warm-up step (the eager
   warm-up of every branch, each level's widest committed so that the
   next level's branches warm up on its rays; 32,768-ray microbatches at
   S = 32 slices per subtile for glass_train, 131,072 rays at S = 8 for
   dragons_pose) is recorded with its outputs, which are held against the
   plain version as in phase 2, in 65,536-ray blocks. (7c) one
   step of each cell under torch.profiler (K1/K1b and table_gather events
   recorded; glass_train's and flagship_train's must hold no event of
   PyTorch's indexing backward, indexing_backward_kernel*).
   Then
   ``raytracer_tpu_torch.examples.inverse_render --pose`` on the card.
   (7d, launch counters zeroed just before) each cell's gradient on one
   fixed state, graphed against graphs=False in turns (graphed, eager,
   eager, graphed): losses bit-equal, every gradient table within rtol
   1e-3, atol 1e-5 (the largest relative difference logged), K1
   launches per step by mode and K1b's equal on both sides (the graphed
   side's counted from the level logs), s/step, the program's parts and
   capture seconds, peak device memory (graphed: allocated + the graph
   pools), each call's host reads of the card counted by torch's sync
   debug mode: a graphed step must make 0 live-count reads, 1 host sync
   (its level logs) and 2 x n_micro graph launches. Only the graphed
   side's launches join the kernels line. Then, in a process of its own
   (``--train-profiles``: in the main process, after phases 2 to 6, the
   profiler reports K1 kernels the counters do not hold), one graphed
   glass_train, flagship_train and dragons_pose gradient and one eager
   dragons_pose gradient under torch.profiler: device busy, idle share,
   the host's cudaGraphLaunch and cudaLaunchKernel calls, and K1's and
   K1b's device and table_gather's device events, each of which must
   equal its kernel's counter's delta (flagship_train launches no K1),
   each hand-written kernel's device time and events (the step-0
   totals of the kernels line), and no indexing_backward_kernel event in
   the glass and flagship gradients. Then each
   cell's s/step (7b, 7d) and device busy (7c, 7d). table_gather's
   forward and grad launches of phase 7 (7d's graphed side
   included) must not be 0. (7e, after the counts are read)
   table_gather replayed with a seeded gradient on glass_train's and
   flagship_train's largest differentiated calls of a table of more
   than one row (real gradients: the material rows), on the largest
   differentiated call of all (flagship_train's one-row padding table,
   every index 0), and on a 2048 x 2048 image's texels (4,194,304 rows,
   the backward's fixed-point route) read by as many indices: the
   forward bit-equal to the plain version, the backward
   twice bit-equal and within rtol 1e-5 of the f64 sum by index (of the
   sum of the terms' magnitudes), the kernels', the plain versions' and
   the library's (table[idx] and its index_put_ backward; index_add_
   beside it) CUDA-event times over a loop of calls (``cuda_ms``) and,
   under names ending in ``graph_ms``, over 20 calls captured in one CUDA
   graph and replayed (the device's pace, the host out of the figure),
   the bound in bytes.
8. packed levels, resumable and multi-process rendering, the examples
   (launch counters zeroed again just before it, and read just after 8d):
   (8a) one dragons_equiv tile and one glass_mesh tile, each packed
   level's live share and width (render.color_at compacts the live rays
   of levels 1 to 4 to R/16, R/4, R/2 or R rows). (8b)
   utils.render_resumable on dragons_equiv 1200x480, stopped after half
   its tiles by an exception from a RenderStats hook, then resumed: the u8
   frame against phase 5's (0.5% budget), rays/s of both parts, any retry
   a failure. (8c) NCCL at world size 1 (a localhost TCP store):
   parallel.render_sharded on dragons_equiv through the tile program,
   one warm-up call then one timed, against render (timed beside it),
   and one graphs=False call (the same frame); one
   make_sharded_train_step step on
   glass_train's 131,072-ray batch against train_step (loss to rtol 1e-5,
   tables to rtol 1e-4), the group torn down. (8d) examples basic_scene,
   csg and hexagon at 1280x720 as subprocesses on the card: each a
   well-formed P3 PPM, timed. Then, their K1 launches kept out of the
   kernels line: 8a's level-2 inputs through _packed_shade_level and
   shade_level, timed with CUDA events, the outputs equal once
   un-permuted; each scene's whole graphed frame with packing off (on a
   second Scene object of the same tables) and on in turns (off, on, on,
   off; host clock), the u8 frames compared; one
   glass_train and one dragons_pose step of phase 7 with packing off and
   on in turns, each with its peak device memory and, from one more step
   under torch.profiler, its device busy time.
9. the differential fuzz (launch counters zeroed again just before its
   frames and gradient, read just after them; the frames graphed): first,
   intersect.mat3_apply on the card (torch's addcmul, a fused
   multiply-add there) must equal the CPU's f64 steps bit for bit. Then
   scenes.random_scene(seed) for seeds 1 to 30 (CSG trees on odd seeds, a
   3x3 area light on seeds divisible by 3, two 6,320-triangle mesh
   instances on even seeds, transparent on seeds divisible by 4;
   deterministic jitter, depth 3) rendered on the card at 64x48, and the
   ten area-light seeds at 64x64, where every level past the first must
   run packed (seed 15's rays all end in the first level); each u8 frame
   against the JAX package's image of the same seed
   (tests/data/torch_fuzz_jax_u8.npz, written by
   tests/torch_fuzz_goldens.py), at most 0.5% of pixels more than one
   step apart. Each case's share, largest step and K1 launches by mode are
   logged; every even seed must launch K1 nearest and any-hit, and every
   seed divisible by 4 the behind mode too. Then render_loss_and_grad of
   seed 12 (a transparent mesh and an area light, 64x48) on the card
   against the CPU, as in 7a. After the counters are read, each frame is
   rendered again through the eager loop (graphs=False), which must give
   the same u8 frame, with its K1 calls recorded: every one is held
   against the plain version as in phase 2, and its pre-pass exactly
   against the torch version. Last, kept out of the kernels line:
   mat3_apply unfused (as before the fuzz's repair) against fused, timed
   with CUDA events at a tile's shapes, then flagship and glass_mesh
   frames in turns (graphed; the unfused frames on a second Scene object
   of the same tables, captured with the unfused function) with each
   one's profiled device time.
10. the compiled frame, one CUDA graph per tile with the level skip and
   the packed widths taken on the card by conditional nodes: (10a) the
   dragons tile's first nearest K1 call and its K1b pre-pass, each
   captured alone in a CUDA graph, replayed on two fresh inputs (the rays
   moved and turned by a little noise) copied into their static buffers:
   K1 against the plain version at phase 2's tolerances, K1b exactly;
   set_conditionals_kernel in a toy tile graph of four IF nodes against
   the host's choice of branch on the same flags (exactly), timed; and a
   toy level of the train program's shape, a backward tile graph of five
   IF bodies (gather vjps) on the flags its forward wrote, against the
   host's choice and gradient (exactly). (10b,
   launch counters zeroed just before and read just after)
   dragons_equiv, glass_mesh, flagship, cli_csg_area_light (random
   jitter) and cli_soft_glass, graphed (render's default) against
   graphs=False in turns: a warm-up of each, then 3 pairs of u8 frames
   and one pair of f32 frames, every pair bit for bit equal; s/frame of
   each side, the parts captured and the conditional bodies among them,
   capture seconds, tile graph launches and host syncs per graphed frame
   (one launch per tile and one sync, or the phase fails), K1 launches
   per frame by mode (the graphed side's counted from the level logs,
   equal to eager's), peak device memory of each side, the graph pool's
   bytes and allocated + pool against eager's peak; only the graphed
   frames' launches join the kernels line, the eager control's are
   logged apart. (10c) one graphed and one eager dragons_equiv frame
   under torch.profiler: device busy, idle share, the host's graph
   launches, kernel launches and stream syncs, and the device events of
   K1's walk (by template) and of K1b, which must equal the launch
   counters' deltas over the same frame. (10d, in a process of its own,
   where no profiler has run) three graphed dragons frames on the host's
   clock, split into set-up, enqueue, the wait for the frame's one sync
   and the host's scatter of the pixels, and the host's time in one tile
   graph launch, alone and back to back.

The last three lines of standard output: the card's name and power limit,
one JSON object with the kernels' numbers (launches: the main-path runs
of phases 5 to 10; set_conditionals_kernel's: phases 7 and 10;
table_gather's: phases 5 and 7, by kernel, its times from 7e's largest
call of a real gradient, each replay's beside them), and the device JSON
object.
Imports nothing of JAX or of the JAX package. The phase-2 cases come from
raytracer_tpu_torch/mesh_cases.py, which tests/test_torch_*.py use too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
        import torch

        if torch.cuda.is_current_stream_capturing():
            # a graph's capture runs nothing: its first occurrence ran
            # eagerly just before and was recorded then
            return self.orig(o, d, planes, bb, **kw)
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


class GatherRecorder:
    """Wraps ops.gather_cuda.table_gather (as intersect.table_gather calls
    it) and counts every call made outside a capture by (G, K, indices,
    dtype, whether the table takes a gradient), keeping a copy of the
    inputs of two calls whose table does: the largest by indices x K
    (``largest``) and the largest of a table of more than one row
    (``largest_rows``); the calls still go through."""

    def __init__(self, ga):
        self.ga = ga
        self.calls = {}
        self.largest = self.largest_rows = None

    def __enter__(self):
        self.orig = self.ga.table_gather
        self.ga.table_gather = self
        return self

    def __exit__(self, *exc):
        self.ga.table_gather = self.orig

    def __call__(self, table, idx):
        import torch

        if not torch.cuda.is_current_stream_capturing():
            g = table.shape[0]
            k = table.numel() // max(g, 1)
            grad = table.requires_grad and torch.is_grad_enabled()
            key = (g, k, idx.numel(), str(table.dtype).replace("torch.", ""),
                   grad)
            self.calls[key] = self.calls.get(key, 0) + 1
            size = idx.numel() * k
            if grad and (self.largest is None or size > self.largest[2]):
                self.largest = (table.detach().clone(), idx.detach().clone(),
                                size)
            if grad and g > 1 and (self.largest_rows is None
                                   or size > self.largest_rows[2]):
                self.largest_rows = (table.detach().clone(),
                                     idx.detach().clone(), size)
        return self.orig(table, idx)

    def summary(self):
        """The calls as [G, K, indices, dtype, differentiated, count],
        largest first."""
        return [[*key, n] for key, n in sorted(
            self.calls.items(), key=lambda kv: -kv[0][2] * kv[0][1])]


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


def prepass_cases(mc, dev):
    """K1b's kernel against its torch version on boxes alone
    (mesh_cases.prepass_case: a subtile that misses everything, tied
    entries, origins inside a box), capped and uncapped, at the test
    cases' supergroup counts and at the most the kernel takes; returns
    check_prepass's largest number."""
    import torch

    from raytracer_tpu_torch import mesh_cases

    err = 0.0
    for ns in (*mesh_cases.PREPASS_SUPERS, mc.PREPASS_SUPER_MAX):
        c = mesh_cases.prepass_case(ns)
        o, d, bb, cap = (torch.as_tensor(c[k], device=dev)
                         for k in ("o", "d", "bb_super", "t_init"))
        for t_cap in (None, cap):
            call = dict(o=o, d=d, bb=(None, bb), t_init=t_cap,
                        reverse=False)
            err = max(err, check_prepass(
                mc, call, f"pre-pass boxes n_super={ns}"))
    log(f"  pre-pass on boxes alone, n_super "
        f"{(*mesh_cases.PREPASS_SUPERS, mc.PREPASS_SUPER_MAX)}, capped and "
        f"uncapped: equal to the torch version")
    return err


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


def profile_run(fn, s_unprofiled, count_kernels=()):
    """One call of ``fn`` under torch.profiler: device busy time (the sum
    of the device-side kernel events), its idle share against the
    un-profiled time of the same call, the top kernels, the host's CUDA
    runtime calls by name (``cudaLaunchKernel``, ``cudaGraphLaunch``,
    copies, syncs), and the device events of each kernel whose name holds
    a string of ``count_kernels`` (``kernel_events``)."""
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
    host_api = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CPU
                and e.key.startswith("cu")}
    return dict(
        profiled_wall_s=wall, device_busy_s=busy_us / 1e6 if kern else None,
        device_idle_share=(1 - busy_us / 1e6 / s_unprofiled) if kern
        else None,
        n_device_ops=sum(e.count for e in kern),
        top=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                  count=e.count) for e in kern[:8]],
        host_api=host_api,
        host_launches=sum(host_api.get(k, 0) for k in (
            "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
            "cuLaunchKernel", "cuLaunchKernelEx", "cuGraphLaunch")),
        kernel_events={s: sum(e.count for e in kern if s in e.key)
                       for s in count_kernels},
        kernel_device_ms={s: sum(e.self_device_time_total for e in kern
                                 if s in e.key) / 1e3
                          for s in count_kernels},
    )


def graph_ms(fn, calls=20, reps=5):
    """``fn``'s time per call with the host out of the figure: ``calls``
    calls captured in one CUDA graph, the graph replayed ``reps`` times
    between CUDA events (ms per call). The launch counters that the
    capture moves are set back: a capture launches nothing, and the
    replays here are no main path's."""
    import torch

    from raytracer_tpu_torch.ops import mesh_cuda as MC

    fn()
    torch.cuda.synchronize()
    before = MC.launch_counts()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    MC.add_launches({k: v - before[k] for k, v in MC.launch_counts().items()},
                    -1)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del g
    return ms


def device_totals(prof):
    """A profile's device time (ms) and events of each hand-written
    kernel (HAND_KERNELS), by name."""
    return {name: dict(ms=prof["kernel_device_ms"][name],
                       launches=prof["kernel_events"][name])
            for name in HAND_KERNELS}


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
    # the same calls replayed from one CUDA graph: the device's pace
    res["graph_ms"] = graph_ms(lambda: mc.mesh_nearest(*args, **kw))
    res["kernel_graph_ms"] = graph_ms(walk)
    res["prepass_graph_ms"] = graph_ms(
        lambda: mc.live_supergroups(o, inv, bb_super, call["t_init"]))
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


def gather_numbers(ga, table, idx, reps=20):
    """7e: table_gather's kernels on one recorded call's inputs (a train
    step's largest differentiated lookup) with a gradient drawn from a
    seed: the forward against the plain version bit for bit; the backward
    twice, bit-equal, and against the f64 sum by index to rtol 1e-5 of
    the sum of the terms' magnitudes (signed sums cancel), as is the plain
    version (``index_add_``, atomics on the card); CUDA-event times of the
    kernels' forward and backward, of the plain versions, and of the
    library's: ``table[idx]`` and its autograd backward (``index_put_``
    with accumulate into zeros), with ``index_add_`` beside it. The bound:
    the bytes both directions must move (indices twice, the output rows
    written and the gradient rows read, the table read and its gradient
    written) over 3.35 TB/s; the adds over the f32 rate are far below.
    The train calls' inputs fit the 50 MB L2, as in the step, so their
    times are warm."""
    import torch

    g, n = table.shape[0], idx.numel()
    k = table.numel() // g
    gen = torch.Generator(device=table.device).manual_seed(11)
    grad = torch.randn((*idx.shape, *table.shape[1:]), device=table.device,
                       generator=gen)
    fwd, plain_fwd = ga.gather_forward(table, idx), ga.gather_forward_plain(
        table, idx)
    if not torch.equal(fwd, plain_fwd):
        raise AssertionError("table_gather: the forward kernel differs from "
                             "its plain version")
    b1, b2 = ga.gather_backward(grad, idx, g), ga.gather_backward(grad, idx,
                                                                   g)
    if not torch.equal(b1, b2):
        raise AssertionError("table_gather: two backward calls differ")
    flat = idx.reshape(-1).clamp(0, g - 1)
    terms = grad.reshape(n, k).double()
    want = torch.zeros((g, k), dtype=torch.float64, device=table.device)
    scale = want.clone().index_add_(0, flat, terms.abs())
    want.index_add_(0, flat, terms)
    plain_bwd = ga.gather_backward_plain(grad, idx, g)
    rel = {}
    for name, x in (("kernel", b1), ("plain", plain_bwd)):
        err = (x.reshape(g, k).double() - want).abs()
        if not bool((err <= 1e-5 * scale).all()):
            raise AssertionError(f"table_gather backward ({name}) is not "
                                 f"within rtol 1e-5 of the f64 sum")
        rel[name] = float((err / scale.clamp_min(1e-30)).max())
    leaf = table.detach().clone()
    zeros2 = torch.zeros((g, k), device=table.device)
    res = dict(
        g=g, k=k, indices=n, table_dtype=str(table.dtype),
        fwd_ms=cuda_ms(lambda: ga.gather_forward(table, idx), reps),
        bwd_ms=cuda_ms(lambda: ga.gather_backward(grad, idx, g), reps),
        plain_fwd_ms=cuda_ms(lambda: ga.gather_forward_plain(table, idx),
                             reps),
        plain_bwd_ms=cuda_ms(lambda: ga.gather_backward_plain(grad, idx, g),
                             reps),
        library_fwd_ms=cuda_ms(lambda: leaf[idx], reps),
        library_bwd_ms=cuda_ms(lambda: torch.zeros_like(leaf).index_put_(
            (idx,), grad, accumulate=True), reps),
        index_add_ms=cuda_ms(lambda: zeros2.zero_().index_add_(
            0, flat, grad.reshape(n, k)), reps),
        # the same calls replayed from one CUDA graph: the device's pace
        fwd_graph_ms=graph_ms(lambda: ga.gather_forward(table, idx)),
        bwd_graph_ms=graph_ms(lambda: ga.gather_backward(grad, idx, g)),
        plain_fwd_graph_ms=graph_ms(
            lambda: ga.gather_forward_plain(table, idx)),
        library_fwd_graph_ms=graph_ms(lambda: leaf[idx]),
        index_add_graph_ms=graph_ms(lambda: zeros2.zero_().index_add_(
            0, flat, grad.reshape(n, k))),
        bwd_route="fixed" if ga._library().table_gather_fixed(n, g, k)
        else "tile",
        workspace_words=int(ga._library().table_gather_workspace(n, g, k)),
        max_rel_err_vs_f64=rel,
        max_abs_err=float((b1 - plain_bwd).abs().max()),
        backward_bit_equal=True, forward_bit_equal=True)
    res["ms"] = res["fwd_ms"] + res["bwd_ms"]
    res["plain_ms"] = res["plain_fwd_ms"] + res["plain_bwd_ms"]
    res["library_ms"] = res["library_fwd_ms"] + res["library_bwd_ms"]
    res["graph_ms"] = res["fwd_graph_ms"] + res["bwd_graph_ms"]
    ib = idx.element_size()
    nbytes = 2 * n * ib + 2 * n * k * 4 + 2 * g * k * table.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n * k / PEAK_F32_FLOPS * 1e3
    res.update(bytes=nbytes, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["graph_bound_share"] = res["bound_ms"] / res["graph_ms"]
    return res


def frame(scene, cam, label, out_dir, mc):
    """Warm-up + median of 3 frames of render() (its default: the tile
    program's CUDA graphs); returns (numbers, the last u8 frame)."""
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
               max_memory_reserved=torch.cuda.max_memory_reserved(),
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
    return o.index_select(0, order), d.index_select(0, order)


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


def pose_cell(dev, dragons):
    """dragons_pose: the dragons_equiv scene (1,061,760 triangles) at
    512x256, the frame from the true eye as the target. Returns (the
    image MSE over an eye, a function of the eye tensor, of ``graphs``
    and of a context around the gradient's call; the eye to start
    from)."""
    import torch

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.core.render import color_at
    from raytracer_tpu_torch.parallel import render_loss_and_grad

    h, v = TRAIN_SIZE
    _, cam = scenes.dragons_equiv(hsize=h, vsize=v)
    frm, to, up = (0.0, 2.5, -10.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)
    order = block_rays(cam, dev)[2]
    with torch.no_grad():
        target = color_at(dragons, *eye_rays(
            cam, torch.tensor(frm, device=dev), order, to, up))
    start = torch.tensor(frm, device=dev) + torch.tensor(
        [0.1, -0.1, -0.1], device=dev)

    def pose_loss(eye, graphs, around=contextlib.nullcontext):
        """The image MSE over the eye: the rays require grad, the scene's
        tables are no parameter (render_loss_and_grad of none);
        ``around`` holds the gradient's call, the camera's forward
        outside it."""
        rays = eye_rays(cam, eye, order, to, up)
        with around():
            loss, _ = render_loss_and_grad(
                {}, lambda _: dragons, *rays, target, remat=False,
                graphs=graphs)
        return loss

    return pose_loss, start


def pose_gradient(pose_loss, start, graphs, around=contextlib.nullcontext):
    """dragons_pose's gradient at the eye ``start``: (loss, {"eye": ...})."""
    at = start.clone().requires_grad_(True)
    loss = pose_loss(at, graphs, around)
    return loss, {"eye": at.grad}


def train_cells(mc, dev, dragons):
    """7b: glass_train and flagship_train (train_step, SGD lr 1e-3 against
    a black target, n_micro=4, remat off: the JAX package's train bench),
    one more glass step with remat on, and dragons_pose (Adam on the eye
    position against the frame from the true eye). Every batch is in
    render's block order. Returns (numbers, {cell: (its step, the state
    to step from, its gradient function of ``graphs`` (and of a context
    around the gradient's call) on one fixed state, its microbatches)}
    for the profiles and 7d, the max |t_kernel - t_plain| over the
    warm-up steps' K1 calls, {cell: the GatherRecorder of glass_train's
    and flagship_train's first step})."""
    import torch

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.ops import gather_cuda as GA
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss_and_grad, train_step)
    from raytracer_tpu_torch.scene import build_scene

    h, v = TRAIN_SIZE
    out, runs, max_err, gathers = {}, {}, 0.0, {}
    for label, (items, cam) in (
            ("glass_train", scenes.glass_mesh(56, h, v)),
            ("flagship_train", scenes.flagship(h, v))):
        sc = build_scene(items, device=dev)
        o, d, _ = block_rays(cam, dev)
        black = torch.zeros_like(o)

        def step(scene, graphs=True, o=o, d=d, black=black):
            return train_step(scene, o, d, black, lr=1e-3, n_micro=4,
                              remat=False, graphs=graphs)

        with GatherRecorder(GA) as gathers[label]:   # the first step's
            out[label], sc, e = timed_steps(label, mc, step, sc, o.shape[0])
        max_err = max(max_err, e)
        out[label]["table_gather_calls"] = gathers[label].summary()
        log(f"  [7b] {label}: table_gather calls of its first step "
            f"[G, K, indices, dtype, differentiated, count]: "
            f"{json.dumps(out[label]['table_gather_calls'])}")

        def grads(graphs, around=contextlib.nullcontext, sc=sc, o=o, d=d,
                  black=black):
            params, recombine = partition_scene(sc)
            with around():
                return render_loss_and_grad(params, recombine, o, d, black,
                                            n_micro=4, remat=False,
                                            graphs=graphs)

        runs[label] = (step, sc, grads, 4)
        out[label].update(triangles=sc.static.counts[5],
                          resolution=f"{h}x{v}", n_micro=4, remat=False)
        if label == "glass_train":
            # a warm-up step captures the remat program's graphs
            train_step(sc, o, d, black, lr=1e-3, n_micro=4, remat=True)
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

    pose_loss, start = pose_cell(dev, dragons)
    eye = start.clone().requires_grad_(True)
    opt = torch.optim.Adam([eye], lr=0.03)
    grads = []

    def pose_step(_, graphs=True):
        opt.zero_grad(set_to_none=True)
        loss = pose_loss(eye, graphs)
        grads.append(eye.grad.detach().cpu().tolist())
        if not bool(torch.isfinite(eye.grad).all()):
            raise AssertionError(f"dragons_pose: gradient {eye.grad}")
        opt.step()
        return loss, None

    def pose_grads(graphs, around=contextlib.nullcontext):
        return pose_gradient(pose_loss, start, graphs, around)

    out["dragons_pose"], _, e = timed_steps("dragons_pose", mc, pose_step,
                                            None, h * v)
    out["dragons_pose"].update(triangles=dragons.static.counts[5],
                               resolution=f"{h}x{v}", eye_grads=list(grads),
                               eye=eye.detach().cpu().tolist())
    runs["dragons_pose"] = (pose_step, None, pose_grads, 1)
    return out, runs, max(max_err, e), gathers


def grad_diff(label, got, want):
    """A graphed cell's (loss, grads) against the eager step's on the same
    state: the loss equal bit for bit, every table to phase 7's card-vs-CPU
    tolerances (rtol 1e-3, atol 1e-5; ``index_add_`` adds in atomic order
    on the card). Returns (largest |difference|, largest relative
    difference over the entries whose eager value is not 0)."""
    import numpy as np
    import torch

    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"{label}: graphed loss {float(got[0])!r} is "
                             f"not the eager loss {float(want[0])!r}")
    worst = rel = 0.0
    for k, g in want[1].items():
        a, b = got[1][k].detach().cpu().numpy(), g.detach().cpu().numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite gradient of {k}")
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5,
                                   err_msg=f"{label}: {k}")
        if a.size:
            worst = max(worst, float(np.abs(a - b).max()))
            nz = b != 0
            if nz.any():
                rel = max(rel, float(
                    (np.abs(a - b)[nz] / np.abs(b[nz])).max()))
    return worst, rel


class SyncProbe:
    """Counts the synchronizing CUDA calls that torch flags, its sync debug
    mode set to warn, inside ``with probe():`` blocks: every read of a
    device value by the host (``.item()``, ``int()``, a copy to pageable
    memory), as the eager step reads each level's live count. An event's
    synchronize is not flagged: the train program's one read of a step,
    which its ``stats["syncs"]`` counts."""

    def __init__(self):
        self.count = 0

    @contextlib.contextmanager
    def __call__(self):
        import warnings

        import torch

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # torch's own notice that the mode is a prototype is no sync
        self.count += sum("synchronizing" in str(w.message)
                          and "prototype" not in str(w.message)
                          for w in caught)


def graphed_vs_eager(mc, runs):
    """7d: each train cell's gradient (the step of 7b without its update,
    on one fixed state) through the train program (a microbatch one
    forward and one backward graph launch, its levels skipped or packed
    by conditional nodes) and through graphs=False in turns (graphed,
    eager, eager, graphed; host clock to a synchronize): the losses
    bit-equal, the gradients within phase 7's tolerances, K1's launches
    by mode and K1b's per step equal on both sides (the graphed side's
    counted from the level logs), the program's parts and capture
    seconds, peak device memory (graphed: allocated + the program's graph
    pools), and each call's host reads of the card (SyncProbe), host
    syncs and graph launches: every graphed step 0 live-count reads, 1
    host sync (the step's read of the level logs) and 2 x n_micro graph
    launches, or the phase fails. Launch counters are read around every
    call: ``launches`` keeps each side's totals, so that only the graphed
    side's join the kernels line. Then, in a process of its own
    (train_profiles), one graphed glass_train and dragons_pose gradient
    under torch.profiler, and one eager dragons_pose gradient."""
    import torch

    from raytracer_tpu_torch.core import train_program as TPG

    out = {}
    launches = {g: dict.fromkeys(mc.launch_counts(), 0)
                for g in ("graphed", "eager")}
    kernels = ("nearest", "any_hit", "behind", "prepass")
    probe = SyncProbe()

    def call(grads, graphs, around=contextlib.nullcontext):
        """One gradient: (loss, grads, seconds, launch counts by counter,
        the program's stats delta (graphed))."""
        stats0 = {id(p): dict(p.stats) for p in TPG.programs()}
        before = mc.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = grads(graphs, around)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in mc.launch_counts().items()}
        for k, v in delta.items():
            launches["graphed" if graphs else "eager"][k] += v
        st = {}
        if graphs:
            prog = TPG.programs()[0]
            was = stats0.get(id(prog), dict.fromkeys(prog.stats, 0))
            st = {k: v - was[k] for k, v in prog.stats.items()}
        return loss, g, sec, delta, st

    for label, (_, _, grads, n_micro) in runs.items():
        res = {g: dict(s=[], k1=[], gather=[], peak=0, host_reads=[],
                       host_syncs=[], graph_launches=[])
               for g in ("graphed", "eager")}
        got = {}
        for graphs in (True, False, False, True):
            side = "graphed" if graphs else "eager"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res[side].setdefault("base", torch.cuda.memory_allocated())
            reads = probe.count
            loss, g, sec, delta, st = call(grads, graphs, probe)
            reads = probe.count - reads
            res[side]["s"].append(sec)
            res[side]["k1"].append({k: delta[k] for k in kernels})
            res[side]["gather"].append({k: delta[k] for k in
                                        GATHER_KERNELS})
            res[side]["host_reads"].append(reads)
            res[side]["host_syncs"].append(reads + st.get("syncs", 0))
            res[side]["graph_launches"].append(st.get("replays", 0))
            res[side]["peak"] = max(res[side]["peak"],
                                    torch.cuda.max_memory_allocated())
            got.setdefault(side, (loss, g))
            if graphs:
                prog = TPG.programs()[0]
        res["max_abs_diff"], res["max_rel_diff"] = grad_diff(
            f"[7d] {label}", got["graphed"], got["eager"])
        for side in ("graphed", "eager"):
            res[side]["s_per_step"] = statistics.median(res[side]["s"])
        if len({json.dumps(x) for x in res["graphed"]["k1"]
                + res["eager"]["k1"]}) != 1:
            raise AssertionError(f"{label}: K1/K1b launches per step differ: "
                                 f"{res['graphed']['k1']} vs "
                                 f"{res['eager']['k1']}")
        res.update(n_micro=n_micro, graphs=len(prog.graphs),
                   stats=dict(prog.stats), levels=prog.levels,
                   graph_pool_bytes=graph_pool_bytes(prog),
                   graphed_over_eager=res["graphed"]["s_per_step"]
                   / res["eager"]["s_per_step"])
        res["peak_graphed_over_eager"] = (
            res["graphed"]["peak"] + res["graph_pool_bytes"]) / res["eager"][
                "peak"]
        log(f"  [7d] {label}, graphed against eager: {json.dumps(res)}")
        want = dict(host_reads=[0, 0], host_syncs=[1, 1],
                    graph_launches=[2 * n_micro] * 2)
        have = {k: res["graphed"][k] for k in want}
        if have != want:
            raise AssertionError(f"{label}: the graphed steps made {have}, "
                                 f"not {want}")
        out[label] = res
    out["launches"] = launches
    proc = subprocess.run(
        [sys.executable, str(HERE / "chip_smoke.py"), "--train-profiles"],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"7d's profiling process failed "
                             f"({proc.returncode}):\n{proc.stdout[-4000:]}"
                             f"{proc.stderr[-4000:]}")
    out["profile"] = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, prof in out["profile"].items():
        log(f"  [7d] one {key.replace(':', ' gradient, ')} under "
            f"torch.profiler, in a process of its own: {json.dumps(prof)}")
    return out


def train_profiles():
    """7d's profiles, in a process of its own (``--train-profiles``): in
    the main process, after phases 2 to 6, torch.profiler reports more K1
    and K1b kernels in a graphed glass_train gradient than the counters
    (and than a process of its own, on the same cell) hold, tiny ones
    under a stale correlation id; here it does not. glass_train,
    flagship_train and dragons_pose on their first state (7b's batches),
    each gradient built and run once, then one graphed gradient of each
    and one eager dragons_pose gradient under torch.profiler
    (profile_run): device busy, idle share against the same call's time
    unprofiled, the host's cudaGraphLaunch and cudaLaunchKernel calls,
    K1's and K1b's device events and table_gather's, which must equal the
    launch counters' deltas (the graphed side's counted from the level
    logs; flagship_train launches no K1), and each hand-written kernel's
    device time and events (``device_totals``). Returns the profiles by
    "cell:side"."""
    import torch

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.ops import mesh_cuda as mc
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss_and_grad)
    from raytracer_tpu_torch.scene import build_scene

    dev = torch.device("cuda")
    h, v = TRAIN_SIZE
    cells = {}
    for label, (items, cam) in (
            ("glass_train", scenes.glass_mesh(56, h, v)),
            ("flagship_train", scenes.flagship(h, v))):
        params, recombine = partition_scene(build_scene(items, device=dev))
        o, d, _ = block_rays(cam, dev)
        cells[label] = (
            lambda graphs, p=params, r=recombine, o=o, d=d:
            render_loss_and_grad(p, r, o, d, torch.zeros_like(o), n_micro=4,
                                 remat=False, graphs=graphs))
    d_items, _ = scenes.dragons_equiv()
    pose_loss, start = pose_cell(dev, build_scene(d_items, device=dev))
    cells["dragons_pose"] = (
        lambda graphs: pose_gradient(pose_loss, start, graphs))
    out = {}
    for label, grads in cells.items():
        for graphs in (True, False) if label == "dragons_pose" else (True,):
            grads(graphs)                   # builds the program
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads(graphs)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            before = mc.launch_counts()
            prof = profile_run(lambda: grads(graphs), sec, count_kernels=(
                *PROFILED_KERNELS, *GATHER_EVENTS, *HAND_KERNELS))
            prof["device_totals"] = device_totals(prof)
            counted = {k: v - before[k] for k, v in mc.launch_counts().items()}
            prof["counted"] = {name: sum(counted[k] for k in keys)
                               for name, keys in PROFILED_KERNELS.items()}
            prof["counted"].update({name: counted[k] for k, name in
                                    GATHER_KERNELS.items()})
            prof["s_unprofiled"] = sec
            side = "graphed" if graphs else "eager"
            out[f"{label}:{side}"] = prof
            events = {k: prof["kernel_events"][k] for k in prof["counted"]}
            if events != prof["counted"]:
                raise AssertionError(
                    f"{label} {side} gradient: the profiler's kernel events "
                    f"{events} differ from the launch counters "
                    f"{prof['counted']}")
            if label != "dragons_pose":
                no_indexing_backward(prof, f"{label} {side} gradient")
    return out


# PyTorch's indexing backward (index_put_ with accumulate), which the
# train steps no longer run, and table_gather's kernels, as the profiler
# names them: counted in the train profiles beside PROFILED_KERNELS
# (by the launch counter of each: ops/gather_cuda.LAUNCHES)
GATHER_KERNELS = {"gather": "table_gather_kernel",
                  "gather_grad": "table_gather_grad_kernel",
                  "gather_scale": "table_gather_scale_kernel",
                  "gather_add": "table_gather_add_kernel",
                  "gather_finish": "table_gather_finish_kernel"}
GATHER_EVENTS = ("indexing_backward_kernel", *GATHER_KERNELS.values())
# the kernels the train cells' lookups launch (their tables are small: the
# backward's tile route); the fixed-point route runs in 7e's texels
PATH_GATHER_KERNELS = ("gather", "gather_grad")


def no_indexing_backward(prof, label):
    """Fails if a profile holds a device event of PyTorch's indexing
    backward: the train steps' lookups go through table_gather."""
    n = prof["kernel_events"]["indexing_backward_kernel"]
    if n:
        raise AssertionError(f"{label}: {n} indexing_backward_kernel "
                             f"events in its profile")


def grad_phase(mc, gc, dev, out_dir, dragons):
    """Phase 7, the differentiable path on the card (launch counters zeroed
    just before it, set_conditionals_kernel's too, read at its end). Its
    numbers keep each train cell's step and state under "runs", for phase
    8's packing off/on steps."""
    from raytracer_tpu_torch.examples import inverse_render
    from raytracer_tpu_torch.ops import gather_cuda as GA

    log("[7] the differentiable path (K1 and set_conditionals launch "
        "counters zeroed)")
    mc.reset_launches()
    gc.set_conditionals_launches = 0
    out = {"parity": grad_parity(mc, dev)}
    cells, runs, out["max_err"], gathers = train_cells(mc, dev, dragons)
    out["cells"], out["runs"] = cells, runs
    for label, (step, state, _, _) in runs.items():
        cells[label]["profile"] = profile_run(
            lambda: step(state), cells[label]["s_per_step"],
            count_kernels=(*PROFILED_KERNELS, *GATHER_EVENTS))
        log(f"  [7c] one {label} step under torch.profiler: "
            f"{json.dumps(cells[label]['profile'])}")
        if label in ("glass_train", "flagship_train"):
            no_indexing_backward(cells[label]["profile"], f"{label} step")
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
    out["gather_launches"] = GA.launch_counts()
    log(f"  K1 launches on the differentiable path: {out['launches']} "
        f"{out['by_mode']}; K1b launches: {out['pre_launches']}; "
        f"table_gather launches: {out['gather_launches']}")
    if out["by_mode"]["nearest"] == 0 or out["by_mode"]["behind"] == 0:
        raise AssertionError(f"phase 7 did not run K1 in nearest and "
                             f"behind modes: {out['by_mode']}")
    log("  [7d] graphed against eager (K1 launch counters zeroed)")
    mc.reset_launches()
    out["graphed_vs_eager"] = ab = graphed_vs_eager(mc, runs)
    graphed = ab["launches"]["graphed"]
    out["launches"] += graphed["k1"]
    out["pre_launches"] += graphed["prepass"]
    out["by_mode"] = {k: out["by_mode"][k] + graphed[k]
                      for k in out["by_mode"]}
    out["gather_launches"] = {k: v + graphed[k] for k, v in
                              out["gather_launches"].items()}
    log(f"  K1 and table_gather launches of 7d's graphed steps: {graphed}; "
        f"the eager control's, kept out of the kernels line: "
        f"{ab['launches']['eager']}")
    if not all(out["gather_launches"][k] for k in PATH_GATHER_KERNELS):
        raise AssertionError(f"phase 7 did not launch table_gather's forward "
                             f"and backward kernels: "
                             f"{out['gather_launches']}")
    steps = {}
    for label, cell in cells.items():
        ge = ab[label]
        steps[label] = dict(
            s_per_step_7b=cell["s_per_step"],
            s_per_step_7d_graphed=ge["graphed"]["s_per_step"],
            s_per_step_7d_eager=ge["eager"]["s_per_step"],
            device_busy_s_7c=cell["profile"]["device_busy_s"],
            device_busy_s_7d=ab["profile"].get(f"{label}:graphed", {}).get(
                "device_busy_s"))
    out["steps"] = steps
    log(f"  [7d] s/step and device busy: {json.dumps(steps)}")
    out["cond_launches"] = gc.set_conditionals_launches
    log(f"  set_conditionals_kernel launches of phase 7 (the train "
        f"programs' forward and backward graphs): {out['cond_launches']}")
    if out["cond_launches"] == 0:
        raise AssertionError("phase 7 launched no set_conditionals_kernel")
    # 7e, after the counts are read: glass_train's and flagship_train's
    # largest differentiated lookups of a table of more than one row, the
    # largest of all (a padding table of one row), and a texture's texels
    out["gather"] = gather_replays(GA, gathers)
    return out


def gather_replays(ga, gathers):
    """7e: gather_numbers on each cell's largest differentiated call of a
    table of more than one row (a real gradient: the material rows), on
    the largest differentiated call of all (flagship_train's one-row
    dummy uv_colors, every index 0), and on the texels of a 2048 x 2048
    image ([4,194,304, 3], the backward's fixed-point route) read by as
    many indices as flagship_train's largest call, spread over the image
    with a tenth on five texels. Returns them by name; "main", the
    largest of the real calls, gives the kernels line its numbers."""
    import torch

    out, real = {}, []
    for label, rec in gathers.items():
        if rec.largest_rows is not None:
            real.append((rec.largest_rows[2], f"{label}:rows"))
            out[f"{label}:rows"] = gather_numbers(ga, *rec.largest_rows[:2])
    label, rec = max(((k, g) for k, g in gathers.items()
                      if g.largest is not None),
                     key=lambda kv: kv[1].largest[2])
    out[f"{label}:largest"] = gather_numbers(ga, *rec.largest[:2])
    n = rec.largest[1].numel()
    gen = torch.Generator(device="cuda").manual_seed(13)
    g = 2048 * 2048
    texels = torch.rand((g, 3), device="cuda", generator=gen)
    idx = torch.where(torch.rand(n, device="cuda", generator=gen) < 0.1,
                      torch.randint(0, 5, (n,), device="cuda", generator=gen),
                      torch.randint(0, g, (n,), device="cuda", generator=gen))
    out["texels_2048"] = gather_numbers(ga, texels, idx)
    for name, res in out.items():
        log(f"  [7e] table_gather on {name}: {json.dumps(res)}")
    if out["texels_2048"]["bwd_route"] != "fixed":
        raise AssertionError("7e: the texels did not take the fixed-point "
                             "route")
    out["main"] = max(real)[1]
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

    def spy(scene_, o, d, w, jitter=None, **kw):
        levels.append(dict(o=o.detach().clone(), d=d.detach().clone(),
                           w=w.detach().clone(), **kw))
        return real(scene_, o, d, w, jitter, **kw)

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


def variant_scene(scene):
    """A second Scene object on the same tables. Tile programs live on the
    scene object, so a variant of a patched module function (render.packs,
    mat3_apply) is captured into CUDA graphs of its own, and each variant's
    timed frames replay its own graphs."""
    import dataclasses

    return dataclasses.replace(scene)


def packing_ab(scene, cam, label):
    """8a: whole frames with the packed levels off (render.packs forced
    False, on a variant_scene) and on, in turns (off, on, on, off) after
    one warm-up frame each (graphed: render's default); host clock to the
    u8 frame on the host. The frames must agree (0.5% budget; packing is
    exact, so 0 pixels are expected)."""
    import numpy as np

    from raytracer_tpu_torch.core import render as R

    real = R.packs
    scenes_ = {"packed": scene, "unpacked": variant_scene(scene)}
    times = {"packed": [], "unpacked": []}
    imgs = {}
    try:
        for mode in ("unpacked", "packed", "packed", "unpacked"):
            R.packs = real if mode == "packed" else (lambda st, r: False)
            if mode not in imgs:                                # warm-up
                imgs[mode] = R.render(scenes_[mode], cam, quantize=True)
            t0 = time.perf_counter()
            imgs[mode] = R.render(scenes_[mode], cam, quantize=True)
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
    then one more step under torch.profiler for its device busy time.
    Levels that do not pack are another train program (its key holds the
    levels' widths), built by an untimed step before the turns."""
    import torch

    from raytracer_tpu_torch.core import render as R

    real = R.packs
    out = {}
    try:
        for label in ("glass_train", "dragons_pose"):
            step, state, _, _ = runs[label]
            res = {m: dict(s=[], max_memory_allocated=[], device_busy_s=[])
                   for m in ("unpacked", "packed")}
            R.packs = lambda st, r: False
            step(state)                              # builds its program
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
    dragons_equiv (graphed, its default: one warm-up call, then one timed)
    against render's graphed frame (timed beside it) and one
    graphs=False call (timed, the same frame bit for bit); one
    make_sharded_train_step step on glass_train's batch against
    train_step (both graphed), then the group torn down."""
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
        want = render(dragons, d_cam)
        res["render_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        render_sharded(dragons, d_cam, mesh)     # warm-up: NCCL, captures
        res["sharded_warmup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = render_sharded(dragons, d_cam, mesh)
        res["sharded_s"] = time.perf_counter() - t0
        res["sharded_over_render"] = res["sharded_s"] / res["render_s"]
        t0 = time.perf_counter()
        eager = render_sharded(dragons, d_cam, mesh, graphs=False)
        res["sharded_eager_s"] = time.perf_counter() - t0
        res["sharded_eager_pixels_differing"] = int(
            (eager != img).any(-1).sum())
        if res["sharded_eager_pixels_differing"]:
            raise AssertionError("render_sharded graphed differs from "
                                 "graphs=False")
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
        dragons.__dict__.pop("_replica", None)   # and its tile program
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


# phase 9: the JAX package's images of the fuzz's random scenes, written
# by tests/torch_fuzz_goldens.py
FUZZ_GOLDENS = HERE / "tests" / "data" / "torch_fuzz_jax_u8.npz"
FUZZ_SEEDS = range(1, 31)
FUZZ_AREA_SEEDS = range(3, 31, 3)     # 64x64 too: the packed levels run
FUZZ_GRAD_SEED = 12    # a transparent mesh (behind mode) and an area light


def fuzz_frames(mc, dev, goldens):
    """9: every fuzz case rendered on the card through render's graphed
    tile program, each against its stored JAX image. Returns (the
    per-case numbers, the cases' (scene, camera, u8 frame)); the scenes'
    programs are dropped after their frame (their graphs' memory)."""
    import numpy as np

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.core import tile_program as TP

    k1 = mc._wrapper
    cases = ([(s, 64, 48) for s in FUZZ_SEEDS]
             + [(s, 64, 64) for s in FUZZ_AREA_SEEDS])
    out, kept = [], []
    for seed, h, v in cases:
        before = dict(k1.launches_by_mode)
        scene, cam = scenes.random_scene(seed, device=dev), \
            scenes.fuzz_camera(h, v)
        img = R.render(scene, cam, quantize=True)
        levels = TP.program_of(scene).levels
        TP.drop_program(scene)
        want = goldens[f"s{seed}_{h}x{v}"]
        if img.shape != want.shape:
            raise AssertionError(f"fuzz seed {seed} {h}x{v}: frame "
                                 f"{img.shape}, JAX {want.shape}")
        diff = np.abs(img.astype(int) - want.astype(int)).max(-1)
        res = dict(seed=seed, size=f"{h}x{v}",
                   share_over_1_step=float((diff > 1).mean()),
                   max_step=int(diff.max()),
                   k1={k: k1.launches_by_mode[k] - before[k]
                       for k in before},
                   level_widths=[r if w is None else w
                                 for _, r, w in levels],
                   packed_widths=[w for _, _, w in levels if w is not None])
        log(f"  [9] seed {seed:>2} {h}x{v}: {json.dumps(res)}")
        out.append(res)
        kept.append((scene, cam, img))
    return out, kept


def fuzz_eager(mc, kept):
    """9, after the main path's counts are read: each fuzz frame again
    through the eager loop (graphs=False) with its K1 calls recorded; the
    u8 frames must equal the graphed ones bit for bit. Returns the
    recorded calls."""
    import numpy as np

    from raytracer_tpu_torch.core import render as R

    differ = []
    with Recorder(mc, outputs=True) as rec:
        for scene, cam, img in kept:
            eager = R.render(scene, cam, quantize=True, graphs=False)
            differ.append(int((eager != img).any(-1).sum()))
    log(f"  [9] graphed fuzz frames vs eager, pixels differing: {differ}")
    if any(differ):
        raise AssertionError(f"graphed fuzz frames differ from eager: "
                             f"{differ}")
    return rec.calls


def fma_check(dev):
    """9: intersect.mat3_apply on the card (torch's f32 addcmul, fused)
    against the CPU (the f64 steps), bit for bit, at the shapes of
    _local_rays, the area-light shadow rays and the per-ray transforms of
    shading and patterns. Returns the entries that differ per shape."""
    import torch

    from raytracer_tpu_torch.core.intersect import mat3_apply

    g = torch.Generator().manual_seed(0)
    out = {}
    for label, (m_shape, x_shape) in dict(
            local=((7, 3, 3), (1 << 16, 1, 3)),
            shadow=((7, 3, 3), (4096, 9, 1, 3)),
            per_ray=((1 << 16, 3, 3), (1 << 16, 3))).items():
        m = torch.randn(m_shape, generator=g)
        x = 3.0 * torch.randn(x_shape, generator=g)
        got = mat3_apply(m.to(dev), x.to(dev)).cpu()
        out[label] = int((got != mat3_apply(m, x)).sum())
    log(f"  [9] mat3_apply cuda vs cpu, entries differing: {json.dumps(out)}")
    if any(out.values()):
        raise AssertionError(f"mat3_apply rounds apart on the card: {out}")
    return out


def unfused_mat3_apply(m, x):
    """intersect.mat3_apply before the fuzz's repair: rounded products
    summed (5 kernels on the card, against the fused chain's 3)."""
    return (x[..., 0:1] * m[..., :, 0] + x[..., 1:2] * m[..., :, 1]
            + x[..., 2:3] * m[..., :, 2])


def mat3_ab(dev, glass, g_cam):
    """9, after the main path's counts are read: mat3_apply unfused
    against fused (the repair) on the card. CUDA-event times at the
    frame's shapes (the object-space rays of a tile against 5 primitives,
    and per-ray transforms), then flagship and glass_mesh frames in turns
    (unfused, fused, fused, unfused, after a warm-up frame each; graphed,
    the unfused frames on a variant_scene), one more frame of each under
    torch.profiler for its device busy time, and the pixels where the two
    frames differ."""
    import numpy as np
    import torch

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.core import intersect as I
    from raytracer_tpu_torch.core import patterns, shading
    from raytracer_tpu_torch.core.render import render
    from raytracer_tpu_torch.scene import build_scene

    fns = {"unfused": unfused_mat3_apply, "fused": I.mat3_apply}

    def use(mode):
        for mod in (I, patterns, shading):
            mod.mat3_apply = fns[mode]

    g = torch.Generator().manual_seed(1)
    out = {"ms": {}}
    for r in (4096, 16384):
        for label, (m_shape, x_shape) in dict(
                local=((5, 3, 3), (r, 1, 3)),
                per_ray=((r, 3, 3), (r, 3))).items():
            m = torch.randn(m_shape, generator=g).to(dev)
            x = torch.randn(x_shape, generator=g).to(dev)
            out["ms"][f"{label}_{r}"] = {
                k: cuda_ms(lambda f=f: f(m, x), 50) for k, f in fns.items()}
    f_items, f_cam = scenes.flagship()
    try:
        for label, scene, cam in (
                ("flagship", build_scene(f_items, device=dev), f_cam),
                ("glass_mesh", glass, g_cam)):
            scenes_ = {"fused": scene, "unfused": variant_scene(scene)}
            times = {k: [] for k in fns}
            imgs = {}
            for mode in ("unfused", "fused", "fused", "unfused"):
                use(mode)
                if mode not in imgs:
                    imgs[mode] = render(scenes_[mode], cam, quantize=True)
                t0 = time.perf_counter()
                imgs[mode] = render(scenes_[mode], cam, quantize=True)
                times[mode].append(time.perf_counter() - t0)
            res = dict(frame_s=times, device_busy_s={})
            for mode in fns:
                use(mode)
                res["device_busy_s"][mode] = profile_run(
                    lambda: render(scenes_[mode], cam, quantize=True),
                    statistics.median(times[mode]))["device_busy_s"]
            res["fused_over_unfused"] = (statistics.median(times["fused"])
                                         / statistics.median(times["unfused"]))
            diff = np.abs(imgs["fused"].astype(int)
                          - imgs["unfused"].astype(int)).max(-1)
            res["pixels_differing"] = int((diff > 0).sum())
            out[label] = res
    finally:
        use("fused")
    log(f"  [9] mat3_apply unfused against fused, in turns: "
        f"{json.dumps(out)}")
    return out


def fuzz_grad(mc, dev):
    """9: render_loss_and_grad of one fuzz seed (a mesh and an area light,
    64x48 in render's block order, a random target) on the card against
    the CPU (card_vs_cpu: phase 7's tolerances). Entries outside them are
    counted per table before the check, so a failure states them."""
    import numpy as np
    import torch

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss_and_grad)

    cam = scenes.fuzz_camera()
    target_np = np.random.default_rng(0).uniform(
        0, 1, (cam.hsize * cam.vsize, 3)).astype(np.float32)
    runs = {}
    for where in (dev, torch.device("cpu")):
        params, recombine = partition_scene(
            scenes.random_scene(FUZZ_GRAD_SEED, device=where))
        o, d, _ = block_rays(cam, where)
        loss, grads = render_loss_and_grad(
            params, recombine, o, d, torch.as_tensor(target_np, device=where))
        runs[where.type] = (float(loss), grads)
    loose = {k: int((~np.isclose(g.detach().cpu().numpy(),
                                 runs["cpu"][1][k].detach().numpy(),
                                 rtol=1e-3, atol=1e-5)).sum())
             for k, g in runs[dev.type][1].items()}
    log(f"  [9] seed {FUZZ_GRAD_SEED} gradients, entries outside rtol "
        f"1e-3 / atol 1e-5 per table: {json.dumps(loose)}")
    worst = card_vs_cpu(f"[9] seed {FUZZ_GRAD_SEED} cuda vs cpu",
                        runs[dev.type], runs["cpu"])
    return dict(seed=FUZZ_GRAD_SEED, loss=runs[dev.type][0],
                loss_cpu=runs["cpu"][0], max_grad_diff_vs_cpu=worst,
                loose_entries=loose)


def fuzz_phase(mc, dev):
    """Phase 9, the differential fuzz on the card (launch counters zeroed
    just before its frames and gradient, read just after them; the
    comparisons with the plain versions come after that read)."""
    import numpy as np

    t0 = time.perf_counter()
    log("[9] the differential fuzz on the card (K1 launch counters zeroed)")
    with np.load(FUZZ_GOLDENS) as z:
        goldens = {k: z[k] for k in z.files}
    log(f"  JAX images made with jax {goldens['jax_version']}, numpy "
        f"{goldens['numpy_version']}")
    fma = fma_check(dev)
    mc.reset_launches()
    cases, kept = fuzz_frames(mc, dev, goldens)
    grad = fuzz_grad(mc, dev)
    out = dict(launches=mc._wrapper.launches,
               by_mode=dict(mc._wrapper.launches_by_mode),
               pre_launches=mc.live_supergroups.launches)
    log(f"  K1 launches on phase 9's path: {out['launches']} "
        f"{out['by_mode']}; K1b launches: {out['pre_launches']}")
    calls = fuzz_eager(mc, kept)
    del kept

    over = [c for c in cases if c["share_over_1_step"] > 0.005]
    if over:
        raise AssertionError(f"fuzz seeds over the 0.5% budget: {over}")
    for c in cases:
        # a 64x64 frame is one 4,096-ray tile: every level past the first
        # runs packed (a frame whose rays all die in the first level, as
        # seed 15's do, has none)
        if c["size"] == "64x64" and (
                len(c["packed_widths"]) != len(c["level_widths"]) - 1):
            raise AssertionError(f"fuzz seed {c['seed']} 64x64: levels "
                                 f"{c['level_widths']}, packed "
                                 f"{c['packed_widths']}")
        if c["size"] != "64x48" or c["seed"] % 2:
            continue
        want = {"nearest", "any_hit"} | (
            {"behind"} if c["seed"] % 4 == 0 else set())
        if not all(c["k1"][m] > 0 for m in want):
            raise AssertionError(f"fuzz seed {c['seed']}: K1 launches "
                                 f"{c['k1']}, wanted modes {sorted(want)}")

    max_err = pre_err = 0.0
    for i, call in enumerate(calls):
        label = f"[9] fuzz K1 call {i}"
        max_err = max(max_err, compare_to_plain(mc, call, call["k"], label))
        pre_err = max(pre_err, check_prepass(mc, call, label))
    if not any(c["packed_widths"] for c in cases if c["size"] == "64x64"):
        raise AssertionError("no 64x64 fuzz frame ran a packed level")
    worst = max(cases, key=lambda c: c["share_over_1_step"])
    out.update(
        cases=cases, grad=grad, mat3_apply_differing=fma,
        k1_calls_checked=len(calls),
        max_err=max_err, pre_err=pre_err,
        worst=dict(seed=worst["seed"], size=worst["size"],
                   share_over_1_step=worst["share_over_1_step"]),
        seeds_with_a_pixel_over_1_step=sorted(
            {c["seed"] for c in cases if c["share_over_1_step"] > 0}),
        largest_step=max(c["max_step"] for c in cases),
        seconds=time.perf_counter() - t0)
    log(f"  [9] {len(cases)} frames within the budget; worst "
        f"{json.dumps(out['worst'])}; seeds with a pixel over one step: "
        f"{out['seeds_with_a_pixel_over_1_step']}; {len(calls)} K1 calls "
        f"against plain, max |dt| {max_err}, pre-pass {pre_err}; "
        f"{out['seconds']:.1f} s")
    return out


# phase 10: the compiled frame
COMPILED_CELLS = ("dragons_equiv", "glass_mesh", "flagship",
                  "cli_csg_area_light", "cli_soft_glass")


def perturbed(call, seed):
    """A K1 call's inputs with fresh rays: origins moved and directions
    turned by a little noise (directions renormalised), the cap kept."""
    import torch

    g = torch.Generator(device=call["o"].device).manual_seed(seed)
    o = call["o"] + 0.01 * torch.randn(call["o"].shape, generator=g,
                                       device=g.device)
    d = call["d"] + 0.02 * torch.randn(call["d"].shape, generator=g,
                                       device=g.device)
    d = d / d.norm(dim=-1, keepdim=True)
    return dict(call, o=o.contiguous(), d=d.contiguous())


def captured_alone(mc, call):
    """10a: one K1 call and its K1b pre-pass, each captured alone in a
    CUDA graph on static input buffers, replayed on two fresh inputs
    copied into those buffers: K1 against the plain version (phase 2's
    tolerances), K1b exactly against its torch version. Returns the
    largest |dt| and the largest K1b difference."""
    import torch

    o, d = call["o"].clone(), call["d"].clone()
    cap = None if call["t_init"] is None else call["t_init"].clone()
    kw = dict(t_init=cap, any_hit=call["any_hit"], reverse=call["reverse"])
    inv = mc.inverse_dirs(-d if call["reverse"] else d).contiguous()
    bb_super = call["bb"][1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up
        mc.mesh_nearest(o, d, call["planes"], call["bb"], **kw)
        mc.live_supergroups(o, inv, bb_super, cap)
    torch.cuda.current_stream().wait_stream(side)
    before = mc.launch_counts()
    g_k1, g_pre = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(g_k1):
        k1_out = mc.mesh_nearest(o, d, call["planes"], call["bb"], **kw)
    with torch.cuda.graph(g_pre):
        pre_out = mc.live_supergroups(o, inv, bb_super, cap)
    mc.add_launches({k: v - before[k] for k, v in mc.launch_counts().items()},
                    -1)
    max_err = pre_err = 0.0
    for seed in (1, 2):
        fresh = perturbed(call, seed)
        o.copy_(fresh["o"])
        d.copy_(fresh["d"])
        inv.copy_(mc.inverse_dirs(-d if call["reverse"] else d))
        g_k1.replay()
        g_pre.replay()
        k = [x.cpu().numpy() for x in k1_out]
        max_err = max(max_err, compare_to_plain(
            mc, fresh, k, f"[10a] K1 {mode_of(call)} graph replay {seed}"))
        p = mc.live_supergroups_plain(o, inv, bb_super, cap)
        differ = {name: int((x != y).sum())
                  for name, x, y in zip(("ids", "cnt", "ent"), pre_out, p)}
        log(f"  [10a] K1b graph replay {seed} vs torch, entries differing: "
            f"{json.dumps(differ)}")
        if any(differ.values()):
            raise AssertionError(f"K1b replay differs from its torch "
                                 f"version: {differ}")
        pre_err = max(pre_err, *map(float, differ.values()))
    return max_err, pre_err


def graph_pool_bytes(prog):
    """Bytes of the device segments in the program's graph memory pools
    (a tile program has one; a train program one more for each forward
    graph whose tensors it keeps)."""
    import torch

    pools = {tuple(p) for p in getattr(prog, "pools", [prog.pool])}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def compiled_cell(mc, label, scene, cam):
    """10b: one cell's frames through the graphed tile program (one CUDA
    graph launch per tile, the level skip and the widths taken on the
    card) and through the eager loop (graphs=False), in turns after a
    warm-up of each: 3 pairs of u8 frames (graphed first, eager first,
    graphed first) and one pair of f32 frames, every pair bit-equal.
    s/frame of each side; the program's parts captured (graphs), of them
    conditional bodies, and the seconds the warm-up, capture and
    instantiation took; tile graph launches and host syncs per graphed
    frame (the program's ``frame_stats``: one launch per tile, one sync,
    the frame's copy to the host); K1 launches per frame by mode (graphed:
    counted from the level logs; must equal eager's); peak device memory
    of each side and the program's graph pool, and allocated + pool
    against eager's peak. Every render call reads the launch counters
    before and after it: ``launches`` holds each side's totals over all
    its frames (warm-up included), kept apart, so that only the graphed
    side's join the kernels line."""
    import torch

    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.core import tile_program as TP

    launches = {g: dict.fromkeys(mc.launch_counts(), 0)
                for g in ("graphed", "eager")}

    def run(graphs, quantize=True):
        torch.cuda.synchronize()
        before = mc.launch_counts()
        t0 = time.perf_counter()
        img = R.render(scene, cam, quantize=quantize, graphs=graphs)
        sec = time.perf_counter() - t0
        side = launches["graphed" if graphs else "eager"]
        for k, v in mc.launch_counts().items():
            side[k] += v - before[k]
        return img, sec

    t0 = time.perf_counter()
    run(True)                                 # warm-up (captures, if new)
    warm_graphed_s = time.perf_counter() - t0
    run(False)
    prog = TP.program_of(scene)
    res = {"graphed": dict(s=[], k1={}, peak_allocated=0),
           "eager": dict(s=[], k1={}, peak_allocated=0)}
    frames, per_frame = {}, []
    for graphs_first in (True, False, True):
        for graphs in ((True, False) if graphs_first else (False, True)):
            side = res["graphed" if graphs else "eager"]
            before = dict(mc.mesh_nearest.launches_by_mode)
            torch.cuda.reset_peak_memory_stats()
            img, sec = run(graphs)
            side["s"].append(sec)
            side["peak_allocated"] = max(side["peak_allocated"],
                                         torch.cuda.max_memory_allocated())
            for k in before:
                side["k1"][k] = side["k1"].get(k, 0) + (
                    mc.mesh_nearest.launches_by_mode[k] - before[k])
            frames.setdefault(graphs, []).append(img)
            if graphs:
                per_frame.append(dict(prog.frame_stats))
    u8_differ = [int((a != b).any(-1).sum())
                 for a, b in zip(frames[True], frames[False])]
    f32 = {g: run(g, quantize=False)[0] for g in (True, False)}
    f32_differ = int((f32[True] != f32[False]).any(-1).sum())
    for side in res.values():
        side["k1"] = {k: v / 3 for k, v in side["k1"].items()}
        side["s_per_frame"] = statistics.median(side["s"])
    tiles = -(-cam.hsize * cam.vsize // prog.tile)
    pool = graph_pool_bytes(prog)
    res.update(
        u8_pixels_differing=u8_differ, f32_pixels_differing=f32_differ,
        graphs=len(prog.graphs), bodies=prog.stats["bodies"],
        tile_graphs=len(prog.tiles), capture_s=prog.stats["capture_s"],
        warm_graphed_s=warm_graphed_s, tiles=tiles,
        replays_per_frame=per_frame[-1]["replays"],
        syncs_per_frame=per_frame[-1]["syncs"], launches=launches,
        graph_pool_bytes=pool,
        allocated_plus_pool_over_eager=(res["graphed"]["peak_allocated"]
                                        + pool)
        / res["eager"]["peak_allocated"],
        graphed_over_eager=res["graphed"]["s_per_frame"]
        / res["eager"]["s_per_frame"])
    log(f"  [10b] {label}: {json.dumps(res)}")
    if any(u8_differ) or f32_differ:
        raise AssertionError(f"{label}: graphed frames differ from eager: "
                             f"u8 {u8_differ}, f32 {f32_differ}")
    if res["graphed"]["k1"] != res["eager"]["k1"]:
        raise AssertionError(f"{label}: K1 launches per frame, graphed "
                             f"{res['graphed']['k1']} vs eager "
                             f"{res['eager']['k1']}")
    if any(f != dict(tiles=tiles, replays=tiles, syncs=1)
           for f in per_frame):
        raise AssertionError(f"{label}: graphed frames were not one tile "
                             f"graph launch per tile and one sync: "
                             f"{per_frame} ({tiles} tiles)")
    return res


def conditionals_check(gc):
    """10a: set_conditionals_kernel on a toy level, a tile graph of four
    IF nodes whose bodies each write their mark, against its plain
    version, the host's choice (``render.taken_branch``) of the same
    flags: for each of 9 flag settings (none, each branch, twice over)
    exactly the flagged branch must run. Its time per launch of that
    graph (CUDA events, 200 launches), the plain version's (flags read on
    the host, then the chosen body's graph replayed; host clock over 200
    decisions) and the bound (the 16 bytes of flags read once). Returns
    the kernels line's numbers (max_abs_err: branches that disagree)."""
    import torch

    from raytracer_tpu_torch.core.render import taken_branch

    out = torch.zeros(4, dtype=torch.int32, device="cuda")
    flags = torch.zeros(4, dtype=torch.int32, device="cuda")
    pool, side = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
    bodies = []
    for k in range(4):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(side):
            g.capture_begin(pool=pool)
            out[k].fill_(k + 1)
            g.capture_end()
        g.instantiate()
        bodies.append(g)
    tg = gc.TileGraph([(flags, bodies)])
    wrong = 0
    for k in (None, 0, 1, 2, 3, 3, 2, 1, 0):
        flags.zero_()
        out.zero_()
        if k is not None:
            flags[k] = 1
        tg.launch()
        want = taken_branch(flags.cpu())
        got = [j for j, x in enumerate(out.cpu().tolist()) if x]
        wrong += got != ([] if want is None else [want])
    flags.zero_()
    flags[2] = 1
    ms = cuda_ms(tg.launch, 200)

    def plain():
        k = taken_branch(flags.cpu())
        if k is not None:
            bodies[k].replay()

    plain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / 200 * 1e3
    res = dict(max_abs_err=float(wrong), ms=ms, plain_ms=plain_ms,
               bound_ms=flags.numel() * 4 / PEAK_BYTES_PER_S * 1e3,
               bound_by="bytes", library_ms=None)
    log(f"  [10a] set_conditionals_kernel on a toy level of 4 branches vs "
        f"the host's choice: {json.dumps(res)}")
    if wrong:
        raise AssertionError(f"set_conditionals: {wrong} launches ran "
                             f"other branches than the flags say")
    return res


def backward_conditionals_check(gc):
    """10a: set_conditionals_kernel on a toy level of the train program's
    shape: a forward tile graph whose predicates part writes five flags
    (the four packed widths of a 4,096-ray mesh level and the dead level,
    render.level_predicates(..., dead=True)) from a live count, and a
    backward tile graph whose five IF bodies, each the captured vjp of a
    gather (index_put_'s accumulate, as in a level's backward), read
    those kept flags. For 8 live counts (0, the widths' edges, the whole
    level) exactly the flagged body must write its gradient, equal to the
    host's (render.taken_branch of the flags, then the gradient in
    torch). Returns the number of launches whose bodies disagree."""
    import torch

    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.core import types as T

    st = T.SceneStatic(counts=(0, 0, 0, 0, 0, 25280))
    rows = 4096
    branches = R.level_branches(st, rows, dead=True)
    n = len(branches)
    live = torch.zeros((), dtype=torch.int64, device="cuda")
    flags = torch.zeros(n, dtype=torch.int32, device="cuda")
    x = torch.rand((64, 3), device="cuda", requires_grad=True)
    idx = torch.randint(0, 64, (rows,), device="cuda")
    out = torch.zeros((n, 64, 3), device="cuda")
    pool, side = torch.cuda.graph_pool_handle(), torch.cuda.Stream()

    def pred():
        flags.copy_(R.level_predicates(st, rows, live, dead=True))

    def body(k):
        with torch.enable_grad():
            (g,) = torch.autograd.grad((x[idx] * float(k + 1)).sum(), x)
        out[k].copy_(g)

    def captured(fn):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
            g = torch.cuda.CUDAGraph(keep_graph=True)
            g.capture_begin(pool=pool)
            fn()
            g.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        return g

    # the parts outlive the tile graphs: their pool and memory are
    # what the graphs' kernels address
    pred_part = captured(pred)
    bodies = [captured(lambda k=k: body(k)) for k in range(n)]
    fwd = gc.TileGraph([pred_part])
    bwd = gc.TileGraph([(flags, bodies)])
    wrong, taken = 0, []
    for n_live in (0, 1, rows // 16, rows // 16 + 1, rows // 4 + 1, rows // 2,
                   rows, 0):
        live.fill_(n_live)
        out.zero_()
        fwd.launch()
        bwd.launch()
        k = R.taken_branch(flags.cpu())
        with torch.enable_grad():
            (want,) = torch.autograd.grad((x[idx] * float(k + 1)).sum(), x)
        got = out.cpu()
        ok = all(torch.equal(got[j], want.cpu() if j == k
                             else torch.zeros(64, 3)) for j in range(n))
        ok &= branches[k] == (R.DEAD if n_live == 0
                              else R.level_width(st, rows, n_live))
        wrong += not ok
        taken.append(str(branches[k]))
    log(f"  [10a] a toy backward level of {n} IF bodies (gather vjps) on "
        f"the flags its forward wrote, 8 live counts: branches taken "
        f"{taken}, launches disagreeing with the host's choice: {wrong}")
    if wrong:
        raise AssertionError(f"backward conditionals: {wrong} launches ran "
                             f"other bodies than the flags say")
    return wrong


# K1's and K1b's device kernels as the profiler names them, and the
# launch counters they stand for: mesh_walk_kernel<true> is the any-hit
# walk, <false> the nearest and behind walks
PROFILED_KERNELS = {"mesh_walk_kernel<false>": ("nearest", "behind"),
                    "mesh_walk_kernel<true>": ("any_hit",),
                    "live_supergroups_kernel": ("prepass",)}
# every hand-written kernel as the profiler names it (a name holding the
# string): its device time and events are summed in the profiles of a
# dragons_equiv frame (10c) and of one gradient of each train cell (7d's
# process), the totals the kernels line carries
HAND_KERNELS = ("table_gather_kernel", "table_gather_grad_kernel",
                "table_gather_scale_kernel",
                "table_gather_add_kernel", "table_gather_finish_kernel",
                "live_supergroups_kernel", "mesh_walk_kernel<false>",
                "mesh_walk_kernel<true>", "mesh_finish_kernel",
                "set_conditionals_kernel")


def profiled_vs_counted(mc, scene, cam, graphs, s_unprofiled):
    """10c: one dragons_equiv frame under torch.profiler (after the
    phase's counts are read): device busy, idle share and the host's
    runtime calls (graph launches and stream syncs among them), and the
    profiler's device events of K1's and K1b's kernels against the launch
    counters' deltas over the same frame (graphed: counted from the level
    logs), which must be equal."""
    from raytracer_tpu_torch.core import render as R

    before = mc.launch_counts()
    prof = profile_run(
        lambda: R.render(scene, cam, quantize=True, graphs=graphs),
        s_unprofiled, count_kernels=(*PROFILED_KERNELS, *HAND_KERNELS))
    counted = {k: v - before[k] for k, v in mc.launch_counts().items()}
    prof["counted"] = {name: sum(counted[k] for k in keys)
                       for name, keys in PROFILED_KERNELS.items()}
    prof["device_totals"] = device_totals(prof)
    if {k: prof["kernel_events"][k] for k in PROFILED_KERNELS} \
            != prof["counted"]:
        raise AssertionError(
            f"dragons_equiv {'graphed' if graphs else 'eager'} frame: the "
            f"profiler's kernel events {prof['kernel_events']} differ from "
            f"the launch counters {prof['counted']}")
    return prof


def host_breakdown(reps=3):
    """10d, in a process of its own (``--host-breakdown``), where no
    torch.profiler has run: once the profiler has traced the card, CUPTI
    stays attached and every later graph launch costs the host
    milliseconds. dragons_equiv is built and one graphed frame captures
    its program; then ``reps`` graphed frames on the host's clock, split
    as ``render`` spends it: set-up (the pixel ids in block order, their
    upload and the camera's), enqueue (``frame``: per tile the ids' copy,
    the jitter draws, one graph launch and two copies), wait
    (``to_host``: the frame's one sync) and the host's scatter of the
    pixels into the image (medians, s); ``render``'s own s/frame over
    ``reps`` frames (median); the host's time in one launch of the u8
    tile graph alone after a sync (median of 10, ms), and in 36 launches
    back to back (the first 3 and the last 3, ms: a launch waits once the
    card's queue is full)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.core import tile_program as TP
    from raytracer_tpu_torch.scene import build_scene

    items, cam = scenes.dragons_equiv()
    scene = build_scene(items, device="cuda")
    R.render(scene, cam, quantize=True)
    prog = TP.program_of(scene)
    n = cam.hsize * cam.vsize
    parts = {k: [] for k in ("setup", "enqueue", "wait", "scatter")}
    frames = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R.render(scene, cam, quantize=True)
        frames.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        order, idx_tiles = R._order_tiles(cam.vsize, cam.hsize, prog.tile,
                                          scene.device)
        inv, consts = R.camera_consts(cam, scene.device)
        t1 = time.perf_counter()
        with torch.no_grad():
            frame = prog.frame(scene, inv, consts, cam.hsize, idx_tiles,
                               True, None)
        t2 = time.perf_counter()
        img = prog.to_host(frame).numpy()[:n]
        t3 = time.perf_counter()
        out = np.empty_like(img)
        out[order] = img
        t4 = time.perf_counter()
        for k, a, b in (("setup", t0, t1), ("enqueue", t1, t2),
                        ("wait", t2, t3), ("scatter", t3, t4)):
            parts[k].append(b - a)
    res = {k: statistics.median(v) for k, v in parts.items()}
    res["total"] = sum(res.values())
    res["render_s_per_frame"] = statistics.median(frames)
    tg = prog.tiles[True]
    alone, in_row = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tg.launch()
        alone.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    for _ in range(36):
        t0 = time.perf_counter()
        tg.launch()
        in_row.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    res.update(launch_alone_ms=statistics.median(alone) * 1e3,
               launches_in_row_ms=in_row[:3] + in_row[-3:])
    return res


def compiled_phase(mc, gc, d_calls, cells):
    """Phase 10, the compiled frame: 10a K1 and K1b captured alone and
    set_conditionals_kernel on a toy level (before the counters are
    zeroed), then the five cells graphed against eager (counters zeroed
    just before, read just after; the kernels line takes the graphed
    frames' launches only, the eager control's are logged apart), then
    one graphed and one eager dragons frame under torch.profiler."""
    log("[10] the compiled frame")
    call = next(c for c in d_calls if mode_of(c) == "nearest")
    out = {}
    out["alone_max_err"], out["alone_pre_err"] = captured_alone(mc, call)
    out["conditionals"] = conditionals_check(gc)
    out["backward_conditionals_wrong"] = backward_conditionals_check(gc)
    log("  (K1 and set_conditionals launch counters zeroed)")
    mc.reset_launches()
    gc.set_conditionals_launches = 0
    out["cells"] = {label: compiled_cell(mc, label, scene, cam)
                    for label, (scene, cam) in cells.items()}
    out["cond_launches"] = gc.set_conditionals_launches
    log(f"  set_conditionals_kernel launches of phase 10's graphed frames: "
        f"{out['cond_launches']}")
    if out["cond_launches"] == 0:
        raise AssertionError("phase 10 launched no set_conditionals_kernel")
    read = mc.launch_counts()
    sides = {g: {k: sum(c["launches"][g][k] for c in out["cells"].values())
                 for k in read} for g in ("graphed", "eager")}
    if {k: sides["graphed"][k] + sides["eager"][k] for k in read} != read:
        raise AssertionError(f"phase 10's counts {read} are not the sum of "
                             f"its frames' {sides}")
    graphed = sides["graphed"]
    out["launches"] = graphed["k1"]
    out["by_mode"] = {k: graphed[k] for k in mc.mesh_nearest.launches_by_mode}
    out["pre_launches"] = graphed["prepass"]
    out["eager_control_launches"] = sides["eager"]
    log(f"  K1 launches of phase 10's graphed frames: {out['launches']} "
        f"{out['by_mode']}; K1b launches: {out['pre_launches']}; the eager "
        f"control's, kept out of the kernels line: {sides['eager']}")
    if out["launches"] == 0:
        raise AssertionError("phase 10 launched no K1")
    scene, cam = cells["dragons_equiv"]
    out["profile"] = {}
    for graphs in (True, False):
        side = "graphed" if graphs else "eager"
        out["profile"][side] = profiled_vs_counted(
            mc, scene, cam, graphs,
            out["cells"]["dragons_equiv"][side]["s_per_frame"])
    log(f"  [10c] one dragons_equiv frame under torch.profiler, graphed and "
        f"eager: {json.dumps(out['profile'])}")
    proc = subprocess.run(
        [sys.executable, str(HERE / "chip_smoke.py"), "--host-breakdown"],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"10d's process failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    out["host_breakdown"] = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  [10d] graphed dragons_equiv frames on the host's clock, in a "
        f"process where no profiler ran (s, medians of 3): "
        f"{json.dumps(out['host_breakdown'])}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(HERE / "build" / "chip_smoke"),
                    help="directory for the PPMs and the numbers")
    ap.add_argument("--host-breakdown", action="store_true",
                    help="only phase 10d's host-clock breakdown of graphed "
                         "dragons_equiv frames, as one JSON line (phase 10 "
                         "runs it in a process of its own)")
    ap.add_argument("--train-profiles", action="store_true",
                    help="only phase 7d's profiled train gradients, as one "
                         "JSON line (phase 7 runs them in a process of its "
                         "own)")
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
    if args.host_breakdown:
        print(json.dumps(host_breakdown()))
        return 0
    if args.train_profiles:
        print(json.dumps(train_profiles()))
        return 0
    import numpy as np

    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch import transforms as tf
    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.core.render import color_at, render
    from raytracer_tpu_torch.mesh_cases import TIE_INDEX
    from raytracer_tpu_torch.ops import gather_cuda as GA
    from raytracer_tpu_torch.ops import graph_cuda as GC
    from raytracer_tpu_torch.ops import mesh_cuda as MC
    from raytracer_tpu_torch.scene import build_scene, specs as S
    from raytracer_tpu_torch.scene.yaml_scene import parse_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    LOG.append(open(out_dir / "chip_smoke.log", "w"))
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_s = {}

    def lap(done):
        """Seconds since the last lap, logged under phase ``done``."""
        now = time.perf_counter()
        phase_s[done] = now - (t_start + sum(phase_s.values()))
        log(f"  (phase {done} took {phase_s[done]:.1f} s)")

    # -- 1. device + build ------------------------------------------------
    smi = smi_line()
    log(f"[1] device: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:     # one nvcc per source, together
        builds = [pool.submit(m.build_library) for m in (MC, GC, GA)]
        (lib_path, build_log), (tg_path, _), (ga_path, ga_log) = [
            b.result() for b in builds]
    log(f"  built {lib_path.name}, {tg_path.name} and {ga_path.name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in (build_log + ga_log).splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "error",
                                   "Compiling entry")):
            log("  ptxas:", line.strip())
    support = GC.versions()
    try:
        GC.check_support()
        support["conditional_nodes"] = True
    except RuntimeError:
        support["conditional_nodes"] = False
    log(f"  conditional graph nodes: {json.dumps(support)}")
    if not support["conditional_nodes"]:
        raise AssertionError(f"no CUDA graph conditional nodes: {support}")

    lap(1)

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
    pre_err = max(pre_err, prepass_cases(MC, dev))
    log(f"  max |dt| over every case {max_err}; pre-pass kernel vs torch "
        f"{pre_err}")
    modes = {mode_of(c) for c in d_calls + g_calls}
    if modes != {"nearest", "any_hit", "behind"}:
        raise AssertionError(f"recorded tiles cover modes {modes}")

    lap(2)

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

    lap(3)

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

    lap(4)

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
    gather_launches = GA.launch_counts()
    log(f"  K1 launches on the main path: {launches} {by_mode}; "
        f"K1b launches: {pre_launches}; table_gather launches: "
        f"{gather_launches}")
    if pre_launches == 0:
        raise AssertionError("the pre-pass kernel was not launched")
    if gather_launches["gather"] == 0:
        raise AssertionError("table_gather's forward kernel was not "
                             "launched")
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

    lap(5)

    # -- 6. the CLI path ----------------------------------------------------
    cli = cli_phase(MC, dev, out_dir, dragons, dragons_img)
    results.update(cli["frames"])
    timing.update(cli["timing"])
    launches += cli["launches"]
    pre_launches += cli["pre_launches"]
    by_mode = {k: by_mode[k] + cli["by_mode"][k] for k in by_mode}
    max_err, pre_err = max(max_err, cli["max_err"]), max(pre_err,
                                                         cli["pre_err"])

    lap(6)

    # -- 7. the differentiable path -----------------------------------------
    grad = grad_phase(MC, GC, dev, out_dir, dragons)
    runs = grad.pop("runs")
    gather_launches = {k: v + grad["gather_launches"][k]
                       for k, v in gather_launches.items()}
    launches += grad.pop("launches")
    pre_launches += grad.pop("pre_launches")
    max_err = max(max_err, grad["max_err"])
    by_mode = {k: by_mode[k] + grad["by_mode"][k] for k in by_mode}

    lap(7)

    # -- 8. packed levels, resumable and sharded rendering, examples ------
    p8 = phase8(MC, dev, out_dir, dragons, d_cam, glass, g_cam, dragons_img,
                runs)
    launches += p8.pop("launches")
    pre_launches += p8.pop("pre_launches")
    by_mode = {k: by_mode[k] + p8["by_mode"][k] for k in by_mode}

    lap(8)

    # -- 9. the differential fuzz ---------------------------------------
    fuzz = fuzz_phase(MC, dev)
    launches += fuzz.pop("launches")
    pre_launches += fuzz.pop("pre_launches")
    side = MC.mesh_nearest.launches
    fuzz["mat3_ab"] = mat3_ab(dev, glass, g_cam)
    fuzz["mat3_ab"]["side_launches"] = MC.mesh_nearest.launches - side
    by_mode = {k: by_mode[k] + fuzz["by_mode"][k] for k in by_mode}
    max_err, pre_err = max(max_err, fuzz["max_err"]), max(pre_err,
                                                          fuzz["pre_err"])
    lap(9)

    # -- 10. the compiled frame --------------------------------------------
    cells = {"dragons_equiv": (dragons, d_cam), "glass_mesh": (glass, g_cam),
             "flagship": (build_scene(f_items, device=dev), f_cam)}
    for label, text, objs in (
            ("cli_csg_area_light", scenes.CSG_AREA_YAML, []),
            ("cli_soft_glass", scenes.SOFT_GLASS_YAML,
             [str(out_dir / "teapot.obj")])):
        cam, sc = parse_scene(text, obj_files=objs, device=dev)
        cells[label] = (sc, cam)
    p10 = compiled_phase(MC, GC, d_calls, cells)
    del cells
    launches += p10.pop("launches")
    pre_launches += p10.pop("pre_launches")
    by_mode = {k: by_mode[k] + p10["by_mode"][k] for k in by_mode}
    max_err = max(max_err, p10["alone_max_err"])
    pre_err = max(pre_err, p10["alone_pre_err"])

    lap(10)
    # step 0: each hand-written kernel's device time and events in one
    # graphed dragons_equiv frame (10c) and one graphed gradient of each
    # train cell (7d's process)
    totals = {"dragons_equiv_frame":
              p10["profile"]["graphed"]["device_totals"]}
    for key, prof in grad["graphed_vs_eager"]["profile"].items():
        cell, side = key.split(":")
        if side == "graphed":
            totals[f"{cell}_gradient"] = prof["device_totals"]
    log(f"  device time (ms) and events of each hand-written kernel: "
        f"{json.dumps(totals)}")

    def device(*names):
        return {where: dict(
            ms=sum(per[n]["ms"] for n in names),
            launches=sum(per[n]["launches"] for n in names))
            for where, per in totals.items()}

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
        "graph_ms": main_k1["graph_ms"],
        "kernel_ms": main_k1["kernel_ms"],
        "kernel_graph_ms": main_k1["kernel_graph_ms"],
        "device": device("mesh_walk_kernel<false>", "mesh_walk_kernel<true>",
                         "mesh_finish_kernel"),
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
        "graph_ms": main_k1["prepass_graph_ms"],
        "device": device("live_supergroups_kernel"),
    }, {
        "name": "set_conditionals",
        "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/tile_graph.cu",
        "replaces": "raytracer_tpu/core/render.py:338",
        "launches": grad.pop("cond_launches") + p10.pop("cond_launches"),
        **p10["conditionals"],
        "device": device("set_conditionals_kernel"),
    }, {
        "name": "table_gather",
        "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/table_gather.cu",
        "replaces": "raytracer_tpu/core/intersect.py:56",
        "replaces_kind": "XLA, not Pallas",
        "launches": sum(gather_launches.values()),
        "launches_by_kernel": gather_launches,
        "call": grad["gather"]["main"],
        **{k: grad["gather"][grad["gather"]["main"]][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "fwd_ms", "bwd_ms", "plain_fwd_ms", "plain_bwd_ms",
            "library_fwd_ms", "library_bwd_ms", "index_add_ms", "graph_ms",
            "fwd_graph_ms", "bwd_graph_ms", "plain_fwd_graph_ms",
            "library_fwd_graph_ms", "index_add_graph_ms", "g", "k",
            "indices", "bwd_route")},
        "device": device(*(n for n in HAND_KERNELS
                           if n.startswith("table_gather"))),
        "device_by_kernel": {n: {w: per[n] for w, per in totals.items()}
                             for n in HAND_KERNELS
                             if n.startswith("table_gather")},
        "by_call": {name: {k: res[k] for k in (
            "g", "k", "indices", "bwd_route", "ms", "plain_ms", "bound_ms",
            "library_ms", "max_abs_err", "fwd_ms", "bwd_ms", "fwd_graph_ms",
            "bwd_graph_ms", "library_fwd_ms", "library_fwd_graph_ms",
            "index_add_ms", "index_add_graph_ms")}
            for name, res in grad["gather"].items() if name != "main"},
    }]
    summary = dict(device=smi, frames=results, kernels=kernels,
                   device_totals=totals,
                   dragons_profile=prof, cli_checks=cli["checks"], grad=grad,
                   phase8=p8, fuzz=fuzz, compiled=p10, phase_s=phase_s,
                   seconds=time.perf_counter() - t_start)
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
