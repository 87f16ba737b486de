#!/usr/bin/env python3
"""Time two versions of the hand-written kernels side by side on one card.

    python3 kernels_ab.py --old DIR [--out DIR]

DIR holds an earlier ``table_gather.cu`` and ``mesh_nearest.cu`` (for
example ``git show <commit>:raytracer_tpu_torch/csrc/table_gather.cu``).
Both versions are built with nvcc beside the current sources' libraries
and called through their C entry points on the same recorded inputs:

* every ``table_gather`` call of one eager flagship_train and one eager
  glass_train gradient (512x256 rays, n_micro=4, as chip_smoke.py's 7b)
  and of dragons_equiv's middle tile, for each (G, K, dtype) the call with
  the most indices: the forward of each, the backward of each one whose
  table takes a gradient;
* a 2048 x 2048 image's texels read by 524,288 indices, a tenth on five
  texels (chip_smoke.py's 7e), forward and backward;
* K1b on every K1 call of dragons_equiv's middle tile.

Each call is timed as 20 calls captured in one CUDA graph and replayed
(ms per call, the host out of the figure), in turns old, new, new, old;
beside it the PyTorch call for the same function (``table[idx]``,
``index_add_`` into zeros). The new forward must equal the old bit for
bit, the new K1b the old exactly, and the new backward must give the same
bits twice; the two backwards may differ in the last bits (another fixed
order of the sum), by at most rtol 1e-5 of the terms' magnitudes.

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


def turns(old, new, timer):
    """old, new, new, old: each side's two times and their mean."""
    t = [timer(f) for f in (old, new, new, old)]
    return dict(old=[t[0], t[3]], new=[t[1], t[2]],
                old_ms=statistics.mean([t[0], t[3]]),
                new_ms=statistics.mean([t[1], t[2]]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier table_gather.cu and "
                         "mesh_nearest.cu")
    ap.add_argument("--out", default=str(HERE / "build" / "kernels_ab"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as CS
    from raytracer_tpu_torch import scenes
    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.ops import gather_cuda as GA
    from raytracer_tpu_torch.ops import mesh_cuda as MC
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss_and_grad)
    from raytracer_tpu_torch.scene import build_scene

    old_dir = Path(args.old)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
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
    res = dict(device=CS.smi_line(), forward=[], backward=[], prepass=[])

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

    (out_dir / "kernels_ab.json").write_text(json.dumps(res, indent=1))
    print(res["device"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
