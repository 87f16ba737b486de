#!/usr/bin/env python3
"""Time two versions of the hand-written kernels side by side on one card.

    python3 kernels_ab.py --old DIR [--out DIR]

DIR holds an earlier ``table_gather.cu`` and ``mesh_nearest.cu``, an
earlier ``tile_graph.cu``, or all three (for example ``git show
<commit>:raytracer_tpu_torch/csrc/table_gather.cu``); each part below
runs where DIR holds its sources. Both versions are built with nvcc
beside the current sources' libraries and called through their C entry
points on the same inputs.

Where DIR holds ``table_gather.cu`` and ``mesh_nearest.cu``, on the same
recorded inputs:

* every ``table_gather`` call of one eager flagship_train and one eager
  glass_train gradient (512x256 rays, n_micro=4, as chip_smoke.py's 7b)
  and of dragons_equiv's middle tile, for each (G, K, dtype) the call with
  the most indices: the forward of each, the backward of each one whose
  table takes a gradient;
* a 2048 x 2048 image's texels read by 524,288 indices, a tenth on five
  texels (chip_smoke.py's 7e), forward and backward;
* K1b on every K1 call of dragons_equiv's middle tile.

Where DIR holds ``mesh_nearest.cu``, K1's walk (``mesh_nearest_launch``:
its merge words' preset, the walk and the finish) on every K1 call of
dragons_equiv's middle tile, on the pre-pass lists of the current K1b,
with its test counter where a build has one (as ``ops/mesh_cuda`` passes
it): the two must give the same t, index, u and v bit for bit; and the
sums over the tile's calls.

Each call is timed as 20 calls captured in one CUDA graph and replayed
(ms per call, the host out of the figure), in turns old, new, new, old;
beside it the PyTorch call for the same function (``table[idx]``,
``index_add_`` into zeros). The new forward must equal the old bit for
bit, the new K1b the old exactly, and the new backward must give the same
bits twice; the two backwards may differ in the last bits (another fixed
order of the sum), by at most rtol 1e-5 of the terms' magnitudes.

Where DIR holds ``tile_graph.cu`` (the level control before
``level_control_kernel``: a captured predicates part, then
``set_conditionals_kernel``, for each level):

* the nodes of the predicates part that the earlier tile and train
  programs captured for a level (the level's flags computed in PyTorch
  ops, here by ``graph_cuda.level_control_plain``, which also computes
  the log entry, and committed into the level's flags), all and kernels,
  on a level that packs and one that does not, at a dragons tile's 16,384
  rays and a train microbatch's 32,768 (with the dead level);
* a toy level's whole graph launch, 200 launches between CUDA events, in
  turns old, new, new, old: a 16,384-ray packing level (four widths),
  old the predicates part, ``set_conditionals_kernel`` and four IF nodes
  with trivial bodies, new ``level_control_kernel`` and the same IF
  nodes; both must run the same bodies on 13 live counts;
* a toy backward of four levels of five IF nodes on kept flags: old one
  ``set_conditionals_kernel`` a level, new one
  ``backward_control_kernel``; both must run the same bodies.

The numbers go to ``DIR_OUT/kernels_ab.json`` and, as one JSON object, to
the last line of standard output after the card's name and power limit.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _bind(path):
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if hasattr(lib, "table_gather_forward"):
        lib.table_gather_workspace.argtypes = [ll, ll, ll]
        lib.table_gather_workspace.restype = ll
        lib.table_gather_forward.argtypes = [p, p, i, p, ll, ll, ll, i, p]
        lib.table_gather_backward.argtypes = [p, p, i, p, p, ll, ll, ll, p, p]
    else:
        lib.live_supergroups_launch.argtypes = [p, p, p, i, p, p, p, p, i, p]
    return lib


class Gather:
    """One build of table_gather.cu, called as its wrapper calls it; the
    forward's word is the widest the build takes (``words``) that divides
    the row's size and both pointers."""

    def __init__(self, lib, words):
        self.lib, self.words = lib, words

    def forward(self, table, idx):
        import torch

        out = torch.empty((*idx.shape, *table.shape[1:]), dtype=table.dtype,
                          device=table.device)
        g = table.shape[0]
        rb = table.numel() // g * table.element_size()
        w = next(w for w in self.words if rb % w == 0
                 and table.data_ptr() % w == 0 and out.data_ptr() % w == 0)
        err = self.lib.table_gather_forward(
            table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
            out.data_ptr(), idx.numel(), g, rb, w,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forward: CUDA error {err}")
        return out

    def backward(self, grad, idx, g):
        import torch

        n = idx.numel()
        k = grad.numel() // n
        out = torch.empty((g, k), device=grad.device)
        words = self.lib.table_gather_workspace(n, g, k)
        work = torch.empty(max(words, 1), device=grad.device)
        launched = (ctypes.c_int * 8)()
        err = self.lib.table_gather_backward(
            grad.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
            out.data_ptr(), work.data_ptr(), n, g, k,
            torch.cuda.current_stream().cuda_stream, launched)
        if err:
            raise RuntimeError(f"backward: CUDA error {err}")
        return out


def prepass(lib, o, inv, bb, cap):
    import torch

    n_sub, ns = o.shape[0] // 256, bb.shape[1]
    ids = torch.empty((n_sub, ns), dtype=torch.int32, device=o.device)
    cnt = torch.empty(n_sub, dtype=torch.int32, device=o.device)
    ent = torch.empty((n_sub, ns), device=o.device)
    err = lib.live_supergroups_launch(
        o.data_ptr(), inv.data_ptr(), bb.data_ptr(), ns,
        None if cap is None else cap.data_ptr(), ids.data_ptr(),
        cnt.data_ptr(), ent.data_ptr(), o.shape[0],
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"live_supergroups: CUDA error {err}")
    return ids, cnt, ent


class Recorder:
    """Wraps ops.gather_cuda.table_gather: keeps, for each (G, K, dtype,
    differentiated), the inputs of the call with the most indices."""

    def __init__(self, ga):
        self.ga, self.calls = ga, {}

    def __enter__(self):
        self.orig = self.ga.table_gather
        self.ga.table_gather = self
        return self

    def __exit__(self, *exc):
        self.ga.table_gather = self.orig

    def __call__(self, table, idx):
        import torch

        g = table.shape[0]
        key = (g, table.numel() // max(g, 1),
               str(table.dtype).replace("torch.", ""),
               table.requires_grad and torch.is_grad_enabled())
        if idx.numel() > self.calls.get(key, (None, None, 0))[2]:
            self.calls[key] = (table.detach().clone(), idx.detach().clone(),
                               idx.numel())
        return self.orig(table, idx)


class OldTileGraph:
    """A tile graph of the earlier ``tile_graph.cu``: captured parts
    (``CUDAGraph``s kept with ``keep_graph=True``) and levels (flags,
    bodies), each ``set_conditionals_kernel`` and one IF node a body."""

    def __init__(self, lib, parts):
        self.lib = lib
        self.graph, self.exec = ctypes.c_void_p(), ctypes.c_void_p()
        last = ctypes.c_void_p()
        self._check(lib.tile_graph_create(ctypes.byref(self.graph)))
        for part in parts:
            if isinstance(part, tuple):
                flags, bodies = part
                arr = (ctypes.c_void_p * len(bodies))(
                    *(b.raw_cuda_graph() for b in bodies))
                self._check(lib.tile_graph_add_level(
                    self.graph, len(bodies), arr, flags.data_ptr(),
                    ctypes.byref(last)))
            else:
                self._check(lib.tile_graph_add_child(
                    self.graph, part.raw_cuda_graph(), ctypes.byref(last)))
        self._check(lib.tile_graph_instantiate(self.graph,
                                               ctypes.byref(self.exec)))

    @staticmethod
    def _check(err):
        if err:
            raise RuntimeError(f"old tile graph: CUDA error {err}")

    def launch(self):
        import torch

        self._check(self.lib.tile_graph_launch(
            self.exec, torch.cuda.current_stream().cuda_stream))

    def __del__(self):
        self.lib.tile_graph_destroy(self.graph, self.exec)


def _bind_old_tile_graph(path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.tile_graph_create.argtypes = [pp]
    lib.tile_graph_add_child.argtypes = [p, p, pp]
    lib.tile_graph_add_level.argtypes = [p, i, pp, p, pp]
    lib.tile_graph_instantiate.argtypes = [p, pp]
    lib.tile_graph_launch.argtypes = [p, p]
    lib.tile_graph_destroy.argtypes = [p, p]
    return lib


def control_ab(old_dir, res):
    """The level control's part (see the module docstring): fills
    ``res["control"]``."""
    import torch

    import chip_smoke as CS
    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.core import types as T
    from raytracer_tpu_torch.ops import graph_cuda as GC
    from raytracer_tpu_torch.ops import mesh_cuda as MC

    GC.check_support()
    path, _ = MC.nvcc_build(old_dir / "tile_graph.cu", GC.NVCC_FLAGS,
                            "tile_graph_old")
    old = _bind_old_tile_graph(path)
    statics = {"packs": T.SceneStatic(counts=(0, 0, 0, 0, 0, 25280)),
               "whole": T.SceneStatic(counts=(3, 1, 0, 0, 0, 0))}
    pool, side = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
    live = torch.zeros((), dtype=torch.int64, device="cuda")
    kept = []       # every graph of the shared pool lives to the end

    def captured(fn):
        kept.append(CS.capture_part(fn, pool, side))
        return kept[-1]

    def predicates(st, rows, flags, dead):
        codes = GC.branch_codes(R.level_branches(st, rows, dead=dead))
        return captured(lambda: flags.copy_(
            GC.level_control_plain(live, rows, codes)[0]))

    out = res["control"] = {"predicates_nodes": {}}
    for kind, st in statics.items():
        for where, rows, dead in (("tile", 16384, False),
                                  ("train", 32768, True)):
            n = len(R.level_branches(st, rows, dead=dead))
            flags = torch.zeros(n, dtype=torch.int32, device="cuda")
            out["predicates_nodes"][f"{where} {rows} {kind}"] = \
                GC.node_counts(predicates(st, rows, flags, dead))
    print(json.dumps(out), flush=True)

    st, rows = statics["packs"], 16384
    branches = R.level_branches(st, rows)
    n = len(branches)
    flags = torch.zeros(n, dtype=torch.int32, device="cuda")
    log_ = torch.zeros(1, dtype=torch.int32, device="cuda")
    marks, bodies = CS.toy_bodies(n, pool, side)
    kept += bodies
    pred = predicates(st, rows, flags, False)
    graphs = {"old": OldTileGraph(old, [pred, (flags, bodies)]),
              "new": GC.TileGraph([GC.Control(live, rows, branches, flags,
                                              log_[0], bodies)])}
    for n_live in (0, 1, rows // 16, rows // 16 + 1, rows // 4, rows // 4 + 1,
                   rows // 2, rows // 2 + 1, rows, 300, 0, rows - 1, 2):
        ran = {}
        for side_, tg in graphs.items():
            live.fill_(n_live)
            marks.zero_()
            tg.launch()
            ran[side_] = (marks.cpu().tolist(), flags.cpu().tolist())
        if ran["old"] != ran["new"]:
            raise AssertionError(f"toy level, {n_live} live: old ran "
                                 f"{ran['old']}, new {ran['new']}")
    live.fill_(rows // 3)
    out["toy_level"] = dict(
        rows=rows, branches=n,
        old_nodes=GC.node_counts(pred),
        **turns(graphs["old"].launch, graphs["new"].launch,
                lambda f: CS.cuda_ms(f, 200)))
    print(json.dumps(out["toy_level"]), flush=True)

    levels = []
    for _ in range(4):
        f = torch.zeros(GC.MAX_BRANCHES, dtype=torch.int32, device="cuda")
        m, bodies = CS.toy_bodies(GC.MAX_BRANCHES, pool, side)
        kept += bodies
        levels.append((f, bodies, m))
    graphs = {"old": OldTileGraph(old, [(f, b) for f, b, _ in levels]),
              "new": GC.TileGraph([GC.Backward([(f, b)
                                                for f, b, _ in levels])])}
    for k in range(-1, GC.MAX_BRANCHES):
        for j, (f, _, _) in enumerate(levels):
            f.zero_()
            if (k + j) % (GC.MAX_BRANCHES + 1) < GC.MAX_BRANCHES:
                f[(k + j) % (GC.MAX_BRANCHES + 1)] = 1
        ran = {}
        for side_, tg in graphs.items():
            for _, _, m in levels:
                m.zero_()
            tg.launch()
            ran[side_] = [m.cpu().tolist() for _, _, m in levels]
        if ran["old"] != ran["new"]:
            raise AssertionError(f"toy backward: old ran {ran['old']}, "
                                 f"new {ran['new']}")
    out["toy_backward"] = dict(
        levels=len(levels), branches=GC.MAX_BRANCHES,
        **turns(graphs["old"].launch, graphs["new"].launch,
                lambda f: CS.cuda_ms(f, 200)))
    print(json.dumps(out["toy_backward"]), flush=True)


def _walk_binding(src, lib):
    """Binds ``mesh_nearest_launch`` of the build of ``src``: with the
    trailing test counter where the source has one."""
    p, i = ctypes.c_void_p, ctypes.c_int
    counted = "u64* tests) {" in src.read_text()
    lib.mesh_nearest_launch.argtypes = [
        p, p, p, p, p, p, p, i, p, i, p, p, p, p, p, p, i, i, p,
        *([p] if counted else [])]
    lib.mesh_nearest_launch.restype = i
    return lib, counted


_COUNTERS = {}


def _counter(dev):
    """A test counter on ``dev``, made outside the timed captures."""
    import torch

    if dev not in _COUNTERS:
        _COUNTERS[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return _COUNTERS[dev]


def walk(binding, o, d, inv, cap, lists, planes, bb_chunk, any_hit):
    """K1's walk of one build on the pre-pass's ``lists``: (t, idx, u, v),
    counting its tests where the build has a test counter."""
    import torch

    lib, counted = binding
    ids, cnt, ent = lists
    r = o.shape[0]
    t = torch.empty(r, device=o.device)
    idx = torch.empty(r, dtype=torch.int32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    best = torch.empty(r, dtype=torch.int64, device=o.device)
    err = lib.mesh_nearest_launch(
        o.data_ptr(), d.data_ptr(), inv.data_ptr(), cap.data_ptr(),
        ids.data_ptr(), cnt.data_ptr(), ent.data_ptr(), ids.shape[1],
        bb_chunk.data_ptr(), bb_chunk.shape[1], planes.data_ptr(),
        best.data_ptr(), t.data_ptr(), idx.data_ptr(), u.data_ptr(),
        v.data_ptr(), r, int(any_hit),
        torch.cuda.current_stream().cuda_stream,
        *((_counter(o.device).data_ptr(),) if counted else ()))
    if err:
        raise RuntimeError(f"mesh_nearest_launch: CUDA error {err}")
    return t, idx, u, v


def walk_ab(old_dir, res):
    """K1's walk, old against new (see the module docstring): fills
    ``res["walk"]`` and ``res["walk_total"]``."""
    import torch

    import chip_smoke as CS
    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.ops import mesh_cuda as MC
    from raytracer_tpu_torch.scene import build_scene

    sides = {}
    for side, src in (("old", old_dir), ("new", HERE / "raytracer_tpu_torch"
                                         / "csrc")):
        path, _ = MC.nvcc_build(src / "mesh_nearest.cu", MC.NVCC_FLAGS,
                                f"mesh_nearest_{side}")
        sides[side] = _walk_binding(src / "mesh_nearest.cu",
                                    ctypes.CDLL(str(path)))
    items, cam = scenes.dragons_equiv()
    dragons = build_scene(items, device=torch.device("cuda"))
    res["walk"] = []
    for i, call in enumerate(CS.record_tile(dragons, cam)):
        d = -call["d"] if call["reverse"] else call["d"]
        inv = MC.inverse_dirs(d).contiguous()
        r = call["o"].shape[0]
        cap = (torch.full((r,), float("inf"), device="cuda")
               if call["t_init"] is None else call["t_init"])
        lists = MC.live_supergroups(call["o"], inv, call["bb"][1],
                                    call["t_init"])
        args = (call["o"], d, inv, cap, lists, call["planes"],
                call["bb"][0], call["any_hit"])
        out = {s: walk(sides[s], *args) for s in sides}
        if not all(torch.equal(a, b) for a, b in zip(out["old"],
                                                     out["new"])):
            raise AssertionError(f"dragons tile call {i}: walks differ")
        row = dict(call=i, mode=CS.mode_of(call), rays=r,
                   live=int(lists[1].sum()),
                   **turns(lambda: walk(sides["old"], *args),
                           lambda: walk(sides["new"], *args), CS.graph_ms))
        res["walk"].append(row)
        print(json.dumps(row), flush=True)
    old = sum(row["old_ms"] for row in res["walk"])
    new = sum(row["new_ms"] for row in res["walk"])
    res["walk_total"] = dict(calls=len(res["walk"]), old_ms=old, new_ms=new,
                             new_over_old=new / old)
    print(json.dumps(res["walk_total"]), flush=True)


def turns(old, new, timer):
    """old, new, new, old: each side's two times and their mean."""
    t = [timer(f) for f in (old, new, new, old)]
    return dict(old=[t[0], t[3]], new=[t[1], t[2]],
                old_ms=statistics.mean([t[0], t[3]]),
                new_ms=statistics.mean([t[1], t[2]]))


def gather_ab(old_dir, res):
    """The gathers' and K1b's part (see the module docstring): fills
    ``res["forward"]``, ``res["backward"]`` and ``res["prepass"]``."""
    import torch

    import chip_smoke as CS
    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.ops import gather_cuda as GA
    from raytracer_tpu_torch.ops import mesh_cuda as MC
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss_and_grad)
    from raytracer_tpu_torch.scene import build_scene

    dev = torch.device("cuda")
    libs = {}
    for side, src in (("old", old_dir), ("new", HERE / "raytracer_tpu_torch"
                                         / "csrc")):
        tg, _ = MC.nvcc_build(src / "table_gather.cu", GA.NVCC_FLAGS,
                              f"table_gather_{side}")
        mn, _ = MC.nvcc_build(src / "mesh_nearest.cu", MC.NVCC_FLAGS,
                              f"mesh_nearest_{side}")
        libs[side] = (_bind(tg), _bind(mn))
    gathers = {"old": Gather(libs["old"][0], (16, 8, 4, 1)),
               "new": Gather(libs["new"][0], (4, 1))}
    res.update(forward=[], backward=[], prepass=[])

    h, v = CS.TRAIN_SIZE
    calls = {}
    for label, (items, cam) in (
            ("flagship_train", scenes.flagship(h, v)),
            ("glass_train", scenes.glass_mesh(56, h, v))):
        params, recombine = partition_scene(build_scene(items, device=dev))
        o, d, _ = CS.block_rays(cam, dev)
        with Recorder(GA) as rec:
            render_loss_and_grad(params, recombine, o, d, torch.zeros_like(o),
                                 n_micro=4, remat=False, graphs=False)
        for key, val in rec.calls.items():
            calls[(label, *key)] = val
    items, cam = scenes.dragons_equiv()
    dragons = build_scene(items, device=dev)
    tile = min(R.pick_tile_rays(dragons.static), cam.hsize * cam.vsize)
    _, idx_tiles = R._order_tiles(cam.vsize, cam.hsize, tile, dev)
    inv, consts = R.camera_consts(cam, dev)
    with torch.no_grad(), Recorder(GA) as rec:
        o, d = R.tile_rays(inv, consts, idx_tiles[len(idx_tiles) // 2],
                           cam.hsize)
        R.color_at(dragons, o, d)
    for key, val in rec.calls.items():
        calls[("dragons_tile", *key)] = val
    gen = torch.Generator(device="cuda").manual_seed(13)
    g, n = 2048 * 2048, 524_288
    texels = torch.rand((g, 3), device="cuda", generator=gen)
    idx = torch.where(torch.rand(n, device="cuda", generator=gen) < 0.1,
                      torch.randint(0, 5, (n,), device="cuda", generator=gen),
                      torch.randint(0, g, (n,), device="cuda", generator=gen))
    calls[("texels_2048", g, 3, "float32", True)] = (texels.detach(), idx, n)

    for (label, g, k, dtype, diff), (table, idx, n) in sorted(
            calls.items(), key=lambda kv: -kv[1][2] * kv[0][2]):
        fo, fn = (gathers[s].forward(table, idx) for s in ("old", "new"))
        if not torch.equal(fo, fn):
            raise AssertionError(f"{label} G {g} K {k}: forwards differ")
        row = dict(call=label, g=g, k=k, dtype=dtype, indices=n,
                   **turns(lambda: gathers["old"].forward(table, idx),
                           lambda: gathers["new"].forward(table, idx),
                           CS.graph_ms),
                   library_ms=CS.graph_ms(lambda: table[idx]))
        res["forward"].append(row)
        print(json.dumps(row), flush=True)
        if not diff or dtype != "float32":
            continue
        grad = torch.randn((n, k), device="cuda", generator=gen)
        bo, bn = (gathers[s].backward(grad, idx, g) for s in ("old", "new"))
        if not torch.equal(bn, gathers["new"].backward(grad, idx, g)):
            raise AssertionError(f"{label} G {g} K {k}: two new backwards "
                                 f"differ")
        scale = torch.zeros((g, k), dtype=torch.float64, device="cuda")
        scale.index_add_(0, idx.reshape(-1).clamp(0, g - 1),
                         grad.double().abs())
        diff_ = (bo.double() - bn.double()).abs()
        if not bool((diff_ <= 1e-5 * scale).all()):
            raise AssertionError(f"{label} G {g} K {k}: backwards differ by "
                                 f"more than rtol 1e-5")
        zeros = torch.zeros((g, k), device="cuda")
        flat = idx.reshape(-1).clamp(0, g - 1)
        row = dict(call=label, g=g, k=k, indices=n,
                   **turns(lambda: gathers["old"].backward(grad, idx, g),
                           lambda: gathers["new"].backward(grad, idx, g),
                           CS.graph_ms),
                   old_vs_new_max_abs=float(diff_.max()),
                   index_add_ms=CS.graph_ms(
                       lambda: zeros.zero_().index_add_(0, flat, grad)))
        res["backward"].append(row)
        print(json.dumps(row), flush=True)

    for i, call in enumerate(CS.record_tile(dragons, cam)):
        dd = -call["d"] if call["reverse"] else call["d"]
        inv = MC.inverse_dirs(dd).contiguous()
        args = (call["o"], inv, call["bb"][1], call["t_init"])
        po, pn = (prepass(libs[s][1], *args) for s in ("old", "new"))
        if not all(torch.equal(x, y) for x, y in zip(po, pn)):
            raise AssertionError(f"dragons tile call {i}: pre-passes differ")
        row = dict(call=i, mode=CS.mode_of(call), rays=call["o"].shape[0],
                   n_super=call["bb"][1].shape[1],
                   live=int(pn[1].sum()),
                   **turns(lambda: prepass(libs["old"][1], *args),
                           lambda: prepass(libs["new"][1], *args),
                           CS.graph_ms))
        res["prepass"].append(row)
        print(json.dumps(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier table_gather.cu and "
                         "mesh_nearest.cu, tile_graph.cu, or all three")
    ap.add_argument("--out", default=str(HERE / "build" / "kernels_ab"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as CS

    old_dir = Path(args.old)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    res = dict(device=CS.smi_line())
    if (old_dir / "tile_graph.cu").exists():
        control_ab(old_dir, res)
    if all((old_dir / f).exists() for f in ("table_gather.cu",
                                            "mesh_nearest.cu")):
        gather_ab(old_dir, res)
    if (old_dir / "mesh_nearest.cu").exists():
        walk_ab(old_dir, res)
    elif "control" not in res:
        print(f"kernels_ab: {old_dir} holds no earlier source",
              file=sys.stderr)
        return 2
    (out_dir / "kernels_ab.json").write_text(json.dumps(res, indent=1))
    print(res["device"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
