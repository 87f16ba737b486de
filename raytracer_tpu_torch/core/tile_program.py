"""The compiled frame: one CUDA graph per tile, the level skip and the
packed width taken on the card by conditional nodes.

Counterpart of the JAX package's ``_tile_color_jit`` and
``_render_frame_jit`` (``raytracer_tpu/core/render.py:516-562``). There a
segment of tiles is one compiled device program, a ``lax.scan`` over the
tiles, in which each level is skipped or run by a ``lax.cond`` on its
live rays (``:413-433``) and a packed level's width comes from a
``lax.cond`` chain on the live count (``_packed_shade_level``,
``:338-348``). PyTorch's counterpart of a compiled program is a CUDA
graph, and of ``lax.cond`` a conditional graph node (CUDA 12.4 or later).
A :class:`TileProgram` runs a tile as one graph:

1. level 0: the primary rays (``render.tile_rays``), the shade, the spawn
   merge and the next level's live count, in a device scalar;
2. for each level L from 1 to the limit, where the scene spawns: one
   kernel, ``level_control_kernel`` (``ops/graph_cuda.Control``), that
   reads the live count and chooses the level's branch among
   ``render.level_branches`` (the widths R/16, R/4, R/2 and R where the
   level packs, else the whole level), as
   ``graph_cuda.level_control_plain`` does: it writes the level's flags
   and its entry of the level log and sets the conditional handles; then
   one IF node per branch, at most one of them run, whose body is
   ``render.level_step`` at that width on the level's buffers: a narrow
   body shades the live rays alone and copies them back into their rows,
   the widest is the whole level. A level whose live count is 0 runs no
   body and leaves the count 0, so every later level is skipped too. A
   tile keeps nothing for a backward, so a blend scene's levels pack here
   too (``render.packs`` with ``keeps=False``), where a train program
   runs them whole;
3. the finish: the image, quantized if asked, into the tile buffer.

``frame`` enqueues per tile the copy of its pixel ids, the draws of its
jitter, one launch of the tile graph and the copies of the tile (into
the frame's buffer, or, for ``render``, straight to its pixels) and of
its level log. The pixel ids of a frame size's tiles are built once and
kept on the device (:meth:`TileProgram.order`). Nothing is read back
until the frame crosses to the host (:meth:`TileProgram.to_host`), its
level logs in the same sync.

Each part (level 0, each branch of each level, the finish) is captured
by PyTorch as a graph of its own that keeps its ``cudaGraph_t``, and
``ops/graph_cuda.TileGraph`` chains them, the branches as the bodies of
IF nodes after each level's control kernel. The parts are captured the
first time a tile runs (the finish and the tile graph once per
``quantize``): first each runs once eagerly on the program's side stream
(K1's shared-memory attribute, cuBLAS and the sort's scratch initialise
there); level 0 and the finish commit their results, a branch commits
nothing, since at a width narrower than the live count it computes wrong
rays. Then each is
captured, which runs nothing. Every tensor a part makes dies inside its
capture, so all the parts share one memory pool.

Every part reads and writes static buffers only: the camera (``inv``,
``consts``), the frame's width (``hsize``), the tile's pixel ids, o/d/w
at each level's width, the image accumulator, the live count,
each level's flags and jitter, the level log and the tile. The random
area-light jitter is drawn before each tile, from the caller's generator,
into every level's buffer at the level's whole width, run or not
(``render.draw_jitter``, the rule ``render.color_at`` follows): graphed
and eager frames are equal bit for bit. The draws stay outside the graph:
a graph-safe generator would advance by every captured draw, run or not,
and the eager loop could not follow it.

The host does not see which branch ran, and replays run kernels that the
Python launch counters of ``ops/mesh_cuda`` never see. So each level's
control kernel writes the branch it chose into the tile's level log on
the device (-1: skipped, 0: run whole, else the packed width), and each
part records its K1 and
K1b launches at capture (taken back off the counters: a capture launches
nothing). :meth:`TileProgram.to_host` reads the logs with the frame,
rebuilds ``levels``, adds each part's launches once for every time it
ran and counts the rows the levels shaded (``rows_shaded``: a level's
logged width, or its rows where it ran whole) and the shadow-sample rays
of their area-light stage (``area_rays``: ``render.area_rays`` at that
width), which it gives the open root span as ``attrs["rows_shaded"]``
and ``attrs["area_rays"]``.

On a CPU scene the program runs the same parts on the same buffers
without capture: the kernel's plain version writes the same flags and
level log entries (``graph_cuda.level_control_cpu``), and the body whose
flag is set runs, the flags read on the host. A card or a PyTorch
without conditional nodes raises (``graph_cuda.check_support``); nothing
falls back to a host-decided loop, to the eager loop or to the CPU.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.ops import graph_cuda as GC
from raytracer_tpu_torch.ops import mesh_cuda as MC
from raytracer_tpu_torch.utils import profiling as P

F32 = torch.float32


def program_for(scene, tile: int, limit: int) -> "TileProgram":
    """The scene's program for tiles of ``tile`` rays and depth ``limit``,
    made on first use. A scene holds one program, so it goes with the
    scene (40 fuzz scenes do not pile up) and a new scene, as a train step
    makes, is captured anew. Asked for another tile or limit, the scene
    drops its program, and with it its graphs' memory pool, and makes a
    new one: pools never pile up on one scene. The camera and the frame's
    width go into the program's buffers (:meth:`TileProgram.set_camera`),
    and ``quantize`` keys the finish and the tile graph within it."""
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
    """A tile as one CUDA graph (see the module docstring).

    ``stats``, counted since the program was made: ``captured`` parts
    (graphs), of them ``bodies`` (conditional bodies), ``capture_s``
    (seconds spent warming up, capturing and instantiating: the clock of
    the ``frame.capture`` span), ``replays``
    (tile graph launches), ``syncs`` (host reads of the card: one per
    frame, :meth:`to_host`), ``rows_shaded`` (the rows the levels
    shaded, read from the level logs), ``area_rays`` (the shadow-sample
    rays of their area-light stage, ``render.area_rays``, from the same
    logs) and ``orders_built`` (the frame
    orders put on the device, :meth:`order`). ``frame_stats``: ``tiles``,
    ``replays`` and ``syncs`` of the last frame. ``levels``: (level,
    rays, width) of every level run since the camera was last set, tile
    by tile, read from the level logs (width None: the level ran whole).
    ``graphs``: the captured parts by key."""

    def __init__(self, static, device, tile: int, limit: int):
        self.static = static
        self.device = torch.device(device)
        self.tile, self.limit = tile, limit
        self.rows = R.level_rows(static, tile, limit)
        self.branches = [R.level_branches(static, r, keeps=False)
                         for r in self.rows]
        self.codes = [GC.branch_codes(b) for b in self.branches]
        self.capture = self.device.type == "cuda"
        self.bufs = {}
        self.graphs = {}          # part key -> (CUDAGraph, launch counts)
        self.tiles = {}           # quantize -> graph_cuda.TileGraph
        self._capturing = False
        self._pending = []        # level logs on their way to the host
        self.inv = self._buf("inv", (4, 4), F32)
        self.consts = self._buf("consts", (3,), F32)
        self.hsize = self._buf("hsize", (), torch.int64)
        self.idx = self._buf("idx", (tile,), torch.int64)
        self.live = self._buf("live", (), torch.int64)
        self.log = self._buf("log", (len(self.rows),), torch.int32)
        if self.capture:
            self.versions = GC.check_support()
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        self.stats = dict(captured=0, bodies=0, capture_s=0.0, replays=0,
                          syncs=0, rows_shaded=0, area_rays=0,
                          orders_built=0)
        self._order = None        # ((h, w), idx_tiles on the device)
        self.frame_stats = dict(tiles=0, replays=0, syncs=0)
        self._levels = []

    @property
    def levels(self):
        """(level, rays, width) of every level run since the camera was
        last set (see the class docstring), the logs still on their way
        read first (:meth:`settle`)."""
        self.settle()
        return self._levels

    # -- buffers -----------------------------------------------------------
    def _buf(self, name, shape, dtype):
        """Buffer ``name``, made (zeroed) on first use: a part warmed up
        on a buffer no tile has written yet reads zero rays."""
        key = (name, tuple(shape), dtype)
        if key not in self.bufs:
            if self._capturing:
                raise RuntimeError(f"tile program: buffer {key} first made "
                                   f"inside a capture")
            self.bufs[key] = torch.zeros(shape, dtype=dtype,
                                         device=self.device)
        return self.bufs[key]

    def _commit(self, outs: dict):
        for name, v in outs.items():
            self._buf(name, v.shape, v.dtype).copy_(v)

    def _jitter(self, level):
        if not R.draws_jitter(self.static):
            return None
        return tuple(self._buf(("jitter", level, ai),
                               (self.rows[level], us * vs, 4), F32)
                     for ai, (us, vs) in enumerate(self.static.area_steps))

    def _flags(self, level):
        return self._buf(("flags", level), (len(self.branches[level]),),
                         torch.int32)

    # -- the parts ---------------------------------------------------------
    def _level0(self, scene):
        r = self.tile
        self.log.fill_(-1)
        self.log[0].fill_(0)
        o, d = R.tile_rays(self.inv, self.consts, self.idx, self.hsize)
        return R.level_step(
            scene, 0, self.limit, o, d,
            torch.ones((r, 3), device=self.device),
            torch.zeros((r, 3), device=self.device), self._jitter(0),
            width=None)

    def _body(self, scene, level, width):
        """Branch ``width`` of ``level``: its results by buffer name."""
        rows = self.rows[level]
        o, d, w = (self._buf(k, (rows, 3), F32) for k in "odw")
        return R.level_step(
            scene, level, self.limit, o, d, w,
            self._buf("img", (self.tile, 3), F32), self._jitter(level),
            width=width)

    def _finish(self, quantize):
        img = self._buf("img", (self.tile, 3), F32)
        return {"tile": R.quantize_u8(img) if quantize else img}

    def _parts(self, scene, quantize):
        """The tile's parts in order: (key, function, whether its eager
        warm-up commits: all but the branches)."""
        out = [(("level", 0), lambda: self._level0(scene), True)]
        for level in range(1, len(self.rows)):
            for width in self.branches[level]:
                out.append(((level, width),
                            lambda level=level, width=width:
                            self._body(scene, level, width), False))
        out.append((("finish", quantize),
                    lambda: self._finish(quantize), True))
        return out

    # -- running -----------------------------------------------------------
    def _run_cpu(self, scene, quantize):
        """The tile on the CPU: the parts in order, each level decided by
        the control kernel's plain version, its flags read on the host."""
        self._commit(self._level0(scene))
        for level in range(1, len(self.rows)):
            k = GC.level_control_cpu(self.live, self.rows[level],
                                     self.codes[level], self._flags(level),
                                     self.log[level])
            if k is not None:
                self._commit(self._body(scene, level,
                                        self.branches[level][k]))
        self._commit(self._finish(quantize))

    def _tile_graph(self, scene, quantize):
        """The tile graph of ``quantize``, built at first use: the parts
        not captured yet warmed up (on the side stream) and captured,
        then chained, each level's branches after its control kernel."""
        if quantize in self.tiles:
            return self.tiles[quantize]
        with P.timed("frame.capture") as sp:
            parts = [p for p in self._parts(scene, quantize)
                     if p[0] not in self.graphs]
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with P.span("capture.warmup"), torch.cuda.stream(self.stream):
                for _, fn, commits in parts:
                    outs = fn()
                    if commits:
                        self._commit(outs)
                    del outs
            with P.span("capture.record"):
                for key, fn, _ in parts:
                    self._capture(key, fn)
            cur.wait_stream(self.stream)
            with P.span("capture.chain"):
                chain = [self.graphs[("level", 0)][0]]
                for level in range(1, len(self.rows)):
                    chain.append(GC.Control(
                        self.live, self.rows[level], self.branches[level],
                        self._flags(level), self.log[level],
                        [self.graphs[(level, w)][0]
                         for w in self.branches[level]]))
                chain.append(self.graphs[("finish", quantize)][0])
                tg = self.tiles[quantize] = GC.TileGraph(chain)
        self.stats["capture_s"] += sp.seconds
        return tg

    def _capture(self, key, fn):
        before = MC.host_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
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
        counts = {k: v - before[k] for k, v in MC.host_counts().items()}
        MC.add_launches(counts, -1)
        self.graphs[key] = (graph, counts)
        self.stats["captured"] += 1
        self.stats["bodies"] += isinstance(key[0], int)

    def set_camera(self, inv, consts, hsize: int):
        """The camera of the next tiles (``render.camera_consts``) and the
        frame's width in pixels: copied into the buffers level 0 reads, so
        a moved camera or another frame size replays the same graphs.
        Starts a new ``levels`` record."""
        self.settle()
        self.inv.copy_(inv)
        self.consts.copy_(consts)
        self.hsize.fill_(hsize)
        self._levels = []

    def order(self, h: int, w: int):
        """The pixel ids of an h x w frame's tiles, [n_tiles, tile] on the
        device (``render._order_tiles``): built and uploaded at the first
        frame of that size (``stats["orders_built"]``), then kept for the
        next frames until one of another size."""
        if self._order is None or self._order[0] != (h, w):
            self._order = (h, w), R._order_tiles(h, w, self.tile,
                                                 self.device)[1]
            self.stats["orders_built"] += 1
        return self._order[1]

    def run_tile(self, scene, idx, generator, quantize: bool):
        """Enqueues one tile of ``tile`` pixel ids: its colours [tile, 3]
        (uint8 with ``quantize``) in the program's tile buffer, valid
        until the next call, and its level log on its way to the host.
        ``generator``: the random jitter's (None when the scene draws
        none). Read the tile through :meth:`to_host`."""
        self._enqueue(scene, idx, generator, quantize)
        self._send_logs(self.log[None], quantize)
        return self._buf("tile", (self.tile, 3),
                         torch.uint8 if quantize else F32)

    def _enqueue(self, scene, idx, generator, quantize):
        self.idx.copy_(idx)
        for level in range(len(self.rows)):
            R.draw_jitter(scene, self.rows[level], generator,
                          out=self._jitter(level))
        if not self.capture:
            self._run_cpu(scene, quantize)
            return
        tg = self._tile_graph(scene, quantize)
        tg.launch(self.device)
        self.stats["replays"] += 1
        self.frame_stats["replays"] += 1

    def _send_logs(self, logs, quantize):
        """Starts the copy of ``logs`` [n, levels] to the host, read by
        :meth:`settle` after the sync of :meth:`to_host`."""
        if not self.capture:
            self._pending.append((logs.clone(), quantize, None))
            return
        host = torch.empty(logs.shape, dtype=logs.dtype, pin_memory=True)
        host.copy_(logs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._pending.append((host, quantize, done))

    def frame(self, scene, idx_tiles, quantize: bool, generator,
              pixels=None):
        """Enqueues every tile of ``idx_tiles`` [n_tiles, tile] of a frame
        into one frame buffer on the device, returned as [n_tiles * tile,
        3] in tile order: one tile graph launch per tile, no read of the
        card, with the camera and the frame's width of :meth:`set_camera`.
        With ``pixels``, the frame's pixel count (``idx_tiles`` of
        :meth:`order`), each tile goes straight to its pixels
        (``render.put_tile``) and the frame is returned in image order,
        [pixels, 3]. Read it through :meth:`to_host`.

        With the span recorder on, the loop is the span
        ``frame.enqueue``, and on the card a pair of timing events, one
        before the first tile's work and one after the frame's last copy,
        gives the open root span the frame's device time
        (``attrs["device_ms"]``, read at :meth:`to_host`'s sync)."""
        self.frame_stats = dict(tiles=len(idx_tiles), replays=0, syncs=0)
        dtype = torch.uint8 if quantize else F32
        out = self._buf("frame", (len(idx_tiles), self.tile, 3), dtype) \
            if pixels is None else self._buf("image", (pixels, 3), dtype)
        logs = self._buf("logs", (len(idx_tiles), len(self.rows)),
                         torch.int32)
        tile = self._buf("tile", (self.tile, 3), dtype)
        with P.span("frame.enqueue"):
            timing = self.capture and P.enabled()
            if timing:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            for ti, idx in enumerate(idx_tiles):
                self._enqueue(scene, idx, generator, quantize)
                if pixels is None:
                    out[ti].copy_(tile)
                else:
                    R.put_tile(out, ti, idx, tile)
                logs[ti].copy_(self.log)
            if timing:
                end.record()
                P.device_span(start, end)
            self._send_logs(logs, quantize)
        return out.reshape(-1, 3)

    def to_host(self, t):
        """``t`` (a frame or a tile of this program, or what was made of
        it on the device) copied to the host, a copy on the CPU too (the
        program's buffers are the next frame's): the frame's one sync,
        which also brings its level logs. Rebuilds ``levels`` from the
        logs, adds the launches of the parts that ran to the counters and
        gives the rows the levels shaded and their area-light rays to the
        open root span (``attrs["rows_shaded"]``, ``attrs["area_rays"]``)."""
        with P.span("frame.wait"):
            out = t.to("cpu", copy=True)
        self.stats["syncs"] += 1
        self.frame_stats["syncs"] += 1
        with P.span("frame.settle"):
            counts, root = self.settle(), P.current_root()
            if root is not None:
                root.attrs.update(counts)
            P.resolve_device_spans()
        return out

    def settle(self):
        """Reads the level logs on their way to the host, extending
        ``levels``, counting the launches of the parts that ran, the rows
        their levels shaded (the logged width, or the level's rows where
        it ran whole) and the shadow-sample rays of the area-light stage
        at those widths (``render.area_rays``), which it returns as
        ``{"rows_shaded": ..., "area_rays": ...}``. After :meth:`to_host`
        they have arrived; otherwise it waits for them."""
        pending, self._pending = self._pending, []
        shaded = area = 0
        for logs, quantize, done in pending:
            if done is not None:
                done.synchronize()
            for log in logs.tolist():
                self._count(("level", 0))
                self._levels.append((0, self.rows[0], None))
                shaded += self.rows[0]
                area += R.area_rays(self.static, self.rows[0])
                for level in range(1, len(self.rows)):
                    if log[level] < 0:
                        continue
                    width = log[level] or None
                    self._count((level, width))
                    self._levels.append((level, self.rows[level], width))
                    shaded += width or self.rows[level]
                    area += R.area_rays(self.static,
                                        width or self.rows[level])
                self._count(("finish", quantize))
        self.stats["rows_shaded"] += shaded
        self.stats["area_rays"] += area
        return dict(rows_shaded=shaded, area_rays=area)

    def _count(self, key):
        if self.capture:
            MC.add_launches(self.graphs[key][1])
