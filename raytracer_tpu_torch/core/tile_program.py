"""The compiled frame: a tile's levels replayed as CUDA graphs.

Counterpart of the JAX package's ``_tile_color_jit`` and
``_render_frame_jit`` (``raytracer_tpu/core/render.py:516-562``). There a
tile, and a ``lax.scan`` over a segment of tiles, is one compiled device
program, so a frame costs a handful of dispatches. PyTorch runs op by op;
its counterpart of a compiled program is a CUDA graph. A
:class:`TileProgram` runs a tile as

1. one graph for the primary rays plus level 0 (``render.tile_rays``, the
   shade, the spawn merge and ``park_rays``), which also writes the next
   level's live count into a device scalar;
2. for each level L >= 1: the host reads that live count (the level's one
   sync, where ``render.color_at`` reads it too), then stops at 0 or
   replays the graph of (L, width), the width from ``render.level_width``
   (a packed width, or the level's whole width);
3. one graph that undoes the composed permutation of the packed levels,
   quantizes if asked and leaves the tile in a buffer, which ``frame``
   copies into the frame on the device.

The JAX package takes the level skip and the width on the device
(``lax.cond``); here the host takes them between graphs, at most one sync
per level, as the eager loop does.

Every graph reads and writes static buffers only: the camera (``inv``,
``consts``) and the frame's width (``hsize``), the tile's pixel ids, o/d/w at each level width, the image
accumulator, ``perm``, the live count, the jitter and the tile. A graph
is captured the first time its (level, width) occurs: that first
occurrence runs eagerly on the program's side stream (K1's shared-memory
attribute, cuBLAS and the sort's scratch initialise there) and commits
its results, then the same function is captured, which runs nothing.
Every tensor a graph makes dies inside its capture, so all the program's
graphs share one memory pool and may replay in any order; never two at
once (one stream). The random area-light jitter is drawn eagerly into its
buffer before each level, from the caller's generator, in the order
``color_at`` draws it: graphed and eager frames are equal bit for bit.

Replays run kernels that the Python launch counters of
``ops/mesh_cuda`` never see, so each graph records its K1 and K1b
launches (by mode) at capture, takes them back off the counters (a
capture launches nothing) and adds them on every replay.

On a CPU scene the program runs the same functions on the same buffers
without capture. A capture or replay error raises; nothing falls back to
the eager loop or to the CPU.
"""

from __future__ import annotations

import time

import torch

from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.ops import mesh_cuda as MC

F32 = torch.float32


def program_for(scene, tile: int, limit: int) -> "TileProgram":
    """The scene's program for tiles of ``tile`` rays and depth ``limit``,
    made on first use. A scene holds one program, so it goes with the
    scene (40 fuzz scenes do not pile up) and a new scene, as a train step
    makes, is captured anew. Asked for another tile or limit, the scene
    drops its program, and with it its graphs' memory pool, and makes a
    new one: pools never pile up on one scene. The camera and the frame's
    width go into the program's buffers (:meth:`TileProgram.set_camera`),
    and ``quantize`` keys the finishing graph within it."""
    prog = scene.__dict__.get("_program")
    if prog is None or (prog.tile, prog.limit) != (tile, limit):
        scene.__dict__.pop("_program", None)
        prog = scene.__dict__["_program"] = TileProgram(
            scene.static, scene.device, tile, limit)
    return prog


def program_of(scene):
    """The scene's program (:func:`program_for`), or None."""
    return scene.__dict__.get("_program")


def drop_program(scene):
    """Drops the scene's program, and with it its graphs' memory."""
    scene.__dict__.pop("_program", None)


class TileProgram:
    """A tile's levels as CUDA graphs (see the module docstring).

    ``stats``: graphs ``captured``, seconds spent capturing
    (``capture_s``), ``replays`` and host ``syncs`` (live-count reads),
    counted since the program was made. ``levels``: (level, rays, width)
    of every level run since the camera was last set, in order (width
    None: the level ran unpacked)."""

    def __init__(self, static, device, tile: int, limit: int):
        self.static = static
        self.device = torch.device(device)
        self.tile, self.limit = tile, limit
        self.thread_perm = not static.has_blend
        # packed levels of a non-blend scene keep their outputs in sorted
        # order: perm composes them (the identity after level 0)
        self.tracks_perm = self.thread_perm and R.packs(static, tile)
        self.capture = self.device.type == "cuda"
        self.bufs = {}
        self.graphs = {}          # key -> (CUDAGraph, its launch counts)
        self._capturing = False
        self.inv = self._buf("inv", (4, 4), F32)
        self.consts = self._buf("consts", (3,), F32)
        self.hsize = self._buf("hsize", (), torch.int64)
        self.idx = self._buf("idx", (tile,), torch.int64)
        if self.capture:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
            self.live_host = torch.zeros((), dtype=torch.int64).pin_memory()
        self.stats = dict(captured=0, capture_s=0.0, replays=0, syncs=0)
        self.levels = []

    # -- buffers -----------------------------------------------------------
    def _buf(self, name, shape, dtype):
        key = (name, tuple(shape), dtype)
        if key not in self.bufs:
            if self._capturing:
                raise RuntimeError(f"tile program: buffer {key} first made "
                                   f"inside a capture")
            self.bufs[key] = torch.empty(shape, dtype=dtype,
                                         device=self.device)
        return self.bufs[key]

    def _commit(self, outs: dict):
        for name, v in outs.items():
            self._buf(name, v.shape, v.dtype).copy_(v)

    def _jitter(self, rows):
        if not R.draws_jitter(self.static):
            return None
        return tuple(self._buf(("jitter", ai), (rows, us * vs, 4), F32)
                     for ai, (us, vs) in enumerate(self.static.area_steps))

    # -- the steps ---------------------------------------------------------
    def _shade(self, scene, level, rows, width, o, d, w, img, perm):
        """One level at ``width`` on its inputs: the render steps, their
        results by buffer name."""
        return R.level_step(
            scene, level, self.limit, o, d, w, img, perm,
            self._jitter(rows if width is None else width), width=width,
            thread_perm=self.thread_perm, tracks_perm=self.tracks_perm)

    def _level0(self, scene):
        r = self.tile
        o, d = R.tile_rays(self.inv, self.consts, self.idx, self.hsize)
        perm = (torch.arange(r, device=self.device) if self.tracks_perm
                else None)
        return self._shade(scene, 0, r, None, o, d,
                           torch.ones((r, 3), device=self.device),
                           torch.zeros((r, 3), device=self.device), perm)

    def _level(self, scene, level, rows, width):
        o, d, w = (self._buf(k, (rows, 3), F32) for k in "odw")
        perm = (self._buf("perm", (self.tile,), torch.int64)
                if self.tracks_perm else None)
        return self._shade(scene, level, rows, width, o, d, w,
                           self._buf("img", (self.tile, 3), F32), perm)

    def _finish(self, quantize):
        perm = (self._buf("perm", (self.tile,), torch.int64)
                if self.tracks_perm else None)
        c = R.finish_step(self._buf("img", (self.tile, 3), F32), perm)
        return {"tile": R.quantize_u8(c) if quantize else c}

    # -- running -----------------------------------------------------------
    def _run(self, key, fn):
        """``fn``'s results into the buffers: on the CPU run directly; on
        cuda replay the graph of ``key``, or at its first occurrence run
        ``fn`` eagerly on the side stream and capture it there."""
        if not self.capture:
            self._commit(fn())
            return
        if key in self.graphs:
            graph, counts = self.graphs[key]
            graph.replay()
            MC.add_launches(counts)
            self.stats["replays"] += 1
            return
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            outs = fn()
        cur.wait_stream(self.stream)
        for v in outs.values():
            v.record_stream(cur)
        self._commit(outs)
        del outs
        t0 = time.perf_counter()
        before = MC.launch_counts()
        graph = torch.cuda.CUDAGraph()
        self._capturing = True
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool)
                try:
                    self._commit(fn())
                finally:
                    graph.capture_end()
        finally:
            self._capturing = False
        counts = {k: v - before[k] for k, v in MC.launch_counts().items()}
        MC.add_launches(counts, -1)
        self.graphs[key] = (graph, counts)
        self.stats["captured"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0

    def _live(self) -> int:
        """The next level's live count on the host: the level's sync."""
        live = self._buf("live", (), torch.int64)
        self.stats["syncs"] += 1
        if not self.capture:
            return int(live)
        self.live_host.copy_(live, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return int(self.live_host)

    def set_camera(self, inv, consts, hsize: int):
        """The camera of the next tiles (``render.camera_consts``) and the
        frame's width in pixels: copied into the buffers every level-0
        graph reads, so a moved camera or another frame size replays the
        same graphs. Starts a new ``levels`` record."""
        self.inv.copy_(inv)
        self.consts.copy_(consts)
        self.hsize.fill_(hsize)
        self.levels = []

    def run_tile(self, scene, idx, generator, quantize: bool):
        """One tile of ``tile`` pixel ids: its colours [tile, 3] (uint8
        with ``quantize``) in the program's tile buffer, valid until the
        next call. ``generator``: the random jitter's (None when the scene
        draws none)."""
        st = self.static
        self.idx.copy_(idx)
        rows = self.tile
        R.draw_jitter(scene, rows, generator, out=self._jitter(rows))
        self._run((0, None), lambda: self._level0(scene))
        self.levels.append((0, rows, None))
        for level in range(1, self.limit + 1):
            if not R.spawns(st):
                break
            n_live = self._live()
            if n_live == 0:
                break
            rows = R.spawn_rows(st, rows)
            width = R.level_width(st, rows, n_live)
            shaded = rows if width is None else width
            R.draw_jitter(scene, shaded, generator, out=self._jitter(shaded))
            self._run((level, width),
                      lambda: self._level(scene, level, rows, width))
            self.levels.append((level, rows, width))
        self._run(("finish", quantize), lambda: self._finish(quantize))
        return self._buf("tile", (self.tile, 3),
                         torch.uint8 if quantize else F32)

    def frame(self, scene, inv, consts, hsize, idx_tiles, quantize: bool,
              generator):
        """Every tile of ``idx_tiles`` [n_tiles, tile] of a frame ``hsize``
        pixels wide into one frame buffer on the device:
        [n_tiles * tile, 3]."""
        self.set_camera(inv, consts, hsize)
        out = self._buf("frame", (len(idx_tiles), self.tile, 3),
                        torch.uint8 if quantize else F32)
        for ti, idx in enumerate(idx_tiles):
            out[ti].copy_(self.run_tile(scene, idx, generator, quantize))
        return out.reshape(-1, 3)
