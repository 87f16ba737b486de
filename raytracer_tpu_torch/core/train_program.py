"""The compiled train step: each level's forward and backward replayed as
CUDA graphs.

Counterpart of the JAX package's jitted train steps (``make_optax_step``
and ``make_sharded_train_step`` in ``raytracer_tpu/parallel/train.py``,
and the train bench's ``jax.jit(train_step)``), where the forward, its
per-level ``jax.checkpoint`` and the backward are one compiled program.
PyTorch's counterpart of a compiled program is a CUDA graph, as in
``core/tile_program.py`` for the frame. A :class:`TrainProgram` runs one
microbatch of ``parallel.train.render_loss_and_grad`` as

1. for each level L, in ``render.color_at``'s order: the host reads the
   level's live count (L >= 1; the level's one sync), stops at 0 or picks
   the width (``render.level_width``), draws the level's random jitter
   into its buffers at the level's whole width (``render.draw_jitter``;
   the levels not run draw theirs after the last), then replays the forward
   graph of (L, width): ``render.level_step`` on the level's input
   buffers, its outputs copied into level L + 1's input buffers;
2. one graph for the loss (the MSE of ``render_loss``) and its gradient
   with respect to the last image;
3. the backward graph of each level run, in reverse order: the vjp of the
   level from the gradients of its outputs (written by the level after
   it, or by the loss graph) to those of its inputs (o, d, w and the
   image) and of the parameters.

Hand-rolled capture, not ``torch.cuda.make_graphed_callables``: the levels
run and their widths are host decisions between graphs, taken anew for
every microbatch, so each (level, width) is its own pair of graphs, found
by key as ``TileProgram`` finds its graphs; and the chain of gradients
from one level's backward to the one before it goes through static
buffers, which a list of separately graphed callables does not give.

Bit-equality with the eager step. A parameter used by several levels gets
its gradient summed over them. The autograd engine of the eager step adds
each contribution as it arrives, the deepest level's first, one at a
time. Each backward graph here therefore takes the sum so far as the
gradient of a view of the parameter made after the level's ops (an
"anchor", the first node the engine runs), so it adds the level's
contributions to it in the eager order. Graphed and eager steps give the
same loss, gradients and updates bit for bit on the CPU; on cuda the loss
is bit-equal and the gradients agree to rounding (``index_add_`` adds in
atomic order there).

Buffers. The parameters live in the program's own leaf tensors (copied
from each step's values by :meth:`TrainProgram.load`), so a train step
that returns a new ``Scene`` does not make a new program: a program is
found again (:func:`program_for`) from what does not change between steps,
the static scene, the frozen tables (the very same tensors), the
parameters' shapes, the microbatch's ray count, ``remat`` and whether the
rays require grad. Every level has buffers of its own (its inputs, its
jitter, the gradients of its inputs), because the backward of a level
reads what its forward read.

Without remat, a forward graph's outputs and the tensors autograd saved
for its backward stay allocated (the captured forward's tensors are
kept), and its backward graph reads them. They live in a memory pool of
that forward graph's own: in the pool the other graphs share, a graph
captured earlier could have its temporaries where a later capture keeps
such tensors, and overwrite them on its next replay. A level's
forward graph therefore overwrites what its previous replay saved: each
microbatch's backward must run before the next forward, and
:meth:`TrainProgram.forward` raises when a forward is pending. With
``remat=True`` (the counterpart of ``jax.checkpoint`` per level) the
forward graph keeps only the level's inputs and jitter, and the backward
graph recomputes the level and takes its vjp.

Each graph is captured the first time its key occurs: that occurrence
runs eagerly on the program's side stream and commits its results (the
step's own), then the same function is captured, which runs nothing, as
in ``TileProgram``. Replays run K1 and K1b without the Python launch
counters seeing them, so each graph records its launches at capture,
takes them back off the counters and adds them on every replay.

The update is not in a graph: ``train_step``'s SGD and a ``torch.optim``
step run eagerly after the graphed gradient (a few launches per table).

On a CPU scene the program runs the same functions on the same buffers
without capture. A capture or replay error raises; nothing falls back to
the eager step or to the CPU.
"""

from __future__ import annotations

import contextlib
import time

import torch

from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.ops import mesh_cuda as MC

F32 = torch.float32
DIFF = ("img", "o", "d", "w")      # a level's differentiable inputs
MAX_PROGRAMS = 4                   # programs kept, most recent first
_PROGRAMS: list = []


def program_for(params, recombine, rows: int, *, remat: bool,
                ray_grad: tuple) -> "TrainProgram":
    """The program for ``params`` (a dict of float tables) placed into a
    scene by ``recombine`` (``partition_scene``'s), microbatches of
    ``rows`` rays, ``remat`` and ``ray_grad`` (whether origins and
    directions require grad), made on first use. Found again while the
    scene's other tables are the same tensors; at most
    :data:`MAX_PROGRAMS` are kept, the least recently used dropped with
    its graphs' memory pool."""
    scene = recombine(params)
    rest = tuple(getattr(scene, k) for k in T.ARRAY_FIELDS
                 if k not in params)
    key = (scene.static, scene.device, rows, bool(remat), tuple(ray_grad),
           tuple((k, tuple(v.shape), v.dtype) for k, v in params.items()))
    for i, prog in enumerate(_PROGRAMS):
        if prog.key == key and all(a is b for a, b in zip(prog.rest, rest)):
            _PROGRAMS.insert(0, _PROGRAMS.pop(i))
            return prog
    prog = TrainProgram(key, recombine, rest)
    _PROGRAMS.insert(0, prog)
    del _PROGRAMS[MAX_PROGRAMS:]
    return prog


def programs() -> list:
    """The programs kept, most recently used first."""
    return list(_PROGRAMS)


def drop_programs():
    """Drops every program, and with them their graphs' memory."""
    _PROGRAMS.clear()


def _reached(outs, params) -> frozenset:
    """Names of the ``params`` (leaf tensors) that the autograd graph of
    ``outs`` reaches: those whose eager ``.grad`` would not stay None."""
    names = {id(p): k for k, p in params.items()}
    found, seen = set(), set()
    stack = [t.grad_fn for t in outs if t.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None and id(var) in names:
            found.add(names[id(var)])
        stack.extend(f for f, _ in fn.next_functions)
    return frozenset(found)


class TrainProgram:
    """A microbatch's levels, loss and backward as CUDA graphs (see the
    module docstring).

    ``stats``: graphs ``captured``, seconds spent capturing
    (``capture_s``), ``replays`` and host ``syncs`` (live-count reads),
    counted since the program was made. ``levels``: (level, rays, width)
    of each level of the last forward. ``graphs``: the keys run so far
    (on the CPU with no graph behind them)."""

    def __init__(self, key, recombine, rest):
        static, device, rows, remat, ray_grad, sig = key
        self.key, self.rest = key, rest
        self.static, self.device, self.rows = static, device, rows
        self.remat, self.ray_grad = remat, ray_grad
        self.limit = static.recursion_limit
        self.level_rows = R.level_rows(static, rows, self.limit)
        self.thread_perm = not static.has_blend
        self.tracks_perm = self.thread_perm and R.packs(static, rows)
        self.capture = device.type == "cuda"
        self.params = {k: torch.zeros(shape, dtype=dtype, device=device,
                                      requires_grad=True)
                       for k, shape, dtype in sig}
        self.scene = recombine(self.params)
        for k, p in self.params.items():
            if getattr(self.scene, k) is not p:
                raise ValueError(
                    f"graphs=True needs a recombine that places each "
                    f"parameter in the scene as it is given (partition_"
                    f"scene's); {k!r} is not: pass graphs=False")
        self.bufs = {}
        self.graphs = {}          # key -> (CUDAGraph, launch counts, kept)
        self.reached = {}         # backward key -> parameters it reaches
        self._valid = {}          # forward key -> this step's outputs
        self._tape = None         # the pending forward's levels
        self._capturing = False
        with torch.no_grad():
            self._put(("o", 0), torch.zeros((rows, 3), device=device,
                                            requires_grad=ray_grad[0]))
            self._put(("d", 0), torch.zeros((rows, 3), device=device,
                                            requires_grad=ray_grad[1]))
            self._put(("w", 0), torch.ones((rows, 3), device=device))
            self._put(("img", 0), torch.zeros((rows, 3), device=device))
            if self.tracks_perm:
                self._put(("perm", 0), torch.arange(rows, device=device))
            for k, p in self.params.items():
                self._put(("acc", k), torch.zeros_like(p))
        if self.capture:
            # the pool every graph's temporaries share; a forward graph
            # whose tensors are kept gets one of its own (``pools``)
            self.pool = torch.cuda.graph_pool_handle()
            self.pools = [self.pool]
            self.stream = torch.cuda.Stream(device)
            self.live_host = torch.zeros((), dtype=torch.int64).pin_memory()
        self.stats = dict(captured=0, capture_s=0.0, replays=0, syncs=0)
        self.levels = []

    # -- buffers -----------------------------------------------------------
    def _put(self, name, value):
        """``value`` into buffer ``name``, made on first use with
        ``value``'s shape, dtype and requires_grad."""
        buf = self.bufs.get(name)
        grad = value.requires_grad
        if buf is None:
            if self._capturing:
                raise RuntimeError(f"train program: buffer {name} first "
                                   f"made inside a capture")
            buf = self.bufs[name] = torch.empty(
                value.shape, dtype=value.dtype,
                device=self.device).requires_grad_(grad)
        elif (buf.shape, buf.dtype, buf.requires_grad) != (
                value.shape, value.dtype, grad):
            raise RuntimeError(f"train program: buffer {name} is "
                               f"{tuple(buf.shape)} {buf.dtype} grad "
                               f"{buf.requires_grad}, given "
                               f"{tuple(value.shape)} {value.dtype} {grad}")
        with torch.no_grad():
            buf.copy_(value)

    def _commit(self, outs: dict):
        for name, v in outs.items():
            self._put(name, v)

    def _jitter(self, level):
        """Level ``level``'s jitter buffers, at its whole width."""
        if not R.draws_jitter(self.static):
            return None
        rows = self.level_rows[level]
        out = []
        for ai, (us, vs) in enumerate(self.static.area_steps):
            name = ("jitter", level, ai)
            if name not in self.bufs:
                self._put(name, torch.zeros((rows, us * vs, 4), dtype=F32,
                                            device=self.device))
            out.append(self.bufs[name])
        return tuple(out)

    @contextlib.contextmanager
    def _side(self):
        """Runs the block on the program's stream (on cuda), ordered after
        the caller's work, and the caller's later work after it."""
        if not self.capture:
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            yield
        cur.wait_stream(self.stream)

    # -- the graphs' functions ---------------------------------------------
    def _outputs(self, level, width):
        """Level ``level``'s outputs from its input buffers, with grad."""
        b = self.bufs
        with torch.enable_grad():
            return R.level_step(
                self.scene, level, self.limit, b[("o", level)],
                b[("d", level)], b[("w", level)], b[("img", level)],
                b.get(("perm", level)), self._jitter(level),
                width=width, thread_perm=self.thread_perm,
                tracks_perm=self.tracks_perm)

    def _fwd_commit(self, level):
        def commit(outs):
            self._commit({("live",) if k == "live" else (k, level + 1): v
                          for k, v in outs.items()})
        return commit

    def _loss(self, end):
        """The MSE of the image after level ``end - 1`` against the target,
        and its gradient with respect to that image; also zeroes the
        parameters' gradient sums for the backward."""
        img = self.bufs[("img", end)]
        with torch.enable_grad():
            c = R.finish_step(img, self.bufs.get(("perm", end)))
            loss = torch.mean((c - self.bufs[("target",)]) ** 2)
            g_img = (torch.autograd.grad(loss, img)[0] if img.requires_grad
                     else torch.zeros_like(img))
        out = {("loss",): loss.detach(), ("g_img", end): g_img}
        for k, p in self.params.items():
            out[("acc", k)] = torch.zeros_like(p)
        return out

    def _bwd(self, level, width, outs):
        """The vjp of level ``level`` at ``width``: the gradients of its
        inputs and the parameters' gradient sums, by buffer name.
        ``outs``: its forward's outputs (None: recompute them, remat)."""
        b = self.bufs
        if outs is None:
            outs = self._outputs(level, width)
        diff = [(outs[k], b[("g_" + k, level + 1)]) for k in DIFF
                if k in outs and outs[k].requires_grad]
        key = ("bwd", level, width)
        if key not in self.reached:
            self.reached[key] = _reached([o for o, _ in diff], self.params)
        ins = [k for k in DIFF if b[(k, level)].requires_grad]
        params = list(self.params.values())
        with torch.enable_grad():
            # made after every node of the level: the engine runs it first,
            # so each parameter's sum so far is the first term its
            # contributions are added to, as in the eager backward
            anchors = [p.view_as(p) for p in params]
        grads = torch.autograd.grad(
            [o for o, _ in diff] + anchors,
            [b[(k, level)] for k in ins] + params,
            [g for _, g in diff] + [b[("acc", k)] for k in self.params],
            retain_graph=not self.remat, allow_unused=True)
        out = {}
        for k, g in zip(ins, grads):
            out[("g_" + k, level)] = (torch.zeros_like(b[(k, level)])
                                      if g is None else g)
        for k, g in zip(self.params, grads[len(ins):]):
            out[("acc", k)] = g
        return out

    # -- running -----------------------------------------------------------
    def _run(self, key, fn, commit, capture_fn=None, keep=False):
        """``fn``'s results into the buffers (``commit``). On the CPU run it
        directly. On cuda replay the graph of ``key``, or at its first
        occurrence run ``fn`` eagerly (the step's results), then capture
        ``capture_fn`` (default ``fn``), keeping the captured outputs with
        ``keep`` (in a memory pool of the graph's own). Returns the eager
        outputs, or None after a replay."""
        if not self.capture:
            outs = fn()
            commit(outs)
            self.graphs.setdefault(key, None)
            return outs
        if key in self.graphs:
            graph, counts, _ = self.graphs[key]
            graph.replay()
            MC.add_launches(counts)
            self.stats["replays"] += 1
            return None
        outs = fn()
        commit(outs)
        t0 = time.perf_counter()
        before = MC.launch_counts()
        graph = torch.cuda.CUDAGraph()
        pool = self.pool
        if keep:
            pool = torch.cuda.graph_pool_handle()
            self.pools.append(pool)
        self._capturing = True
        try:
            graph.capture_begin(pool=pool)
            try:
                captured = (capture_fn or fn)()
                commit(captured)
            finally:
                graph.capture_end()
        finally:
            self._capturing = False
        counts = {k: v - before[k] for k, v in MC.launch_counts().items()}
        MC.add_launches(counts, -1)
        self.graphs[key] = (graph, counts, captured if keep else None)
        self.stats["captured"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        return outs

    def _live(self) -> int:
        """The next level's live count on the host: the level's sync."""
        live = self.bufs[("live",)]
        self.stats["syncs"] += 1
        if not self.capture:
            return int(live)
        self.live_host.copy_(live, non_blocking=True)
        self.stream.synchronize()
        return int(self.live_host)

    def load(self, params: dict):
        """Copies the step's parameter values into the program's."""
        with self._side(), torch.no_grad():
            for k, p in self.params.items():
                p.copy_(params[k])

    def forward(self, origins, directions, target, generator=None):
        """One microbatch's forward: the loss (a buffer of the program,
        valid until the next forward). Raises while the previous
        forward's backward is pending: its graphs would overwrite what
        that backward reads."""
        if self._tape is not None:
            raise RuntimeError(
                "train program: a forward replayed before the backward of "
                "the previous one; call backward() first")
        st = self.static
        if R.draws_jitter(st):
            generator = R._seeded(generator, self.device)
        tape = []
        with self._side():
            self._put(("o", 0), origins)
            self._put(("d", 0), directions)
            self._put(("target",), target)
            level, rows, width = 0, self.rows, None
            while True:
                R.draw_jitter(self.scene, rows, generator,
                              out=self._jitter(level))
                key = ("fwd", level, width)
                outs = self._run(
                    key, lambda: self._outputs(level, width),
                    self._fwd_commit(level), keep=not self.remat)
                if not self.remat:
                    self._valid[key] = (outs if outs is not None
                                        else self.graphs[key][2])
                tape.append((level, rows, width))
                if level == self.limit or not R.spawns(st):
                    break
                n_live = self._live()
                if n_live == 0:
                    break
                level += 1
                rows = R.spawn_rows(st, rows)
                width = R.level_width(st, rows, n_live)
            end = level + 1
            for n in self.level_rows[end:]:   # the levels not run draw too
                R.draw_jitter(self.scene, n, generator)
            self._run(("loss", end), lambda: self._loss(end), self._commit)
        self._tape = self.levels = tape
        return self.bufs[("loss",)]

    def backward(self):
        """The pending forward's backward: (the parameters' gradients by
        name, None for a table the level graphs never reach, as an eager
        leaf's ``.grad`` stays None; the gradients of the origins and the
        directions, None where they do not require grad). Buffers of the
        program, valid until the next backward."""
        if self._tape is None:
            raise RuntimeError("train program: backward() without a "
                               "pending forward")
        tape, self._tape = self._tape, None
        b = self.bufs
        try:
            with self._side():
                last, _, _ = tape[-1]
                for k in ("o", "d", "w"):     # the last level's spawns
                    name = (k, last + 1)
                    if name in b and b[name].requires_grad:
                        self._put(("g_" + k, last + 1),
                                  torch.zeros_like(b[name]))
                for level, _, width in reversed(tape):
                    fkey = ("fwd", level, width)
                    self._run(
                        ("bwd", level, width),
                        lambda: self._bwd(level, width,
                                          self._valid.get(fkey)),
                        self._commit,
                        capture_fn=lambda: self._bwd(
                            level, width, None if self.remat
                            else self.graphs[fkey][2]))
        finally:
            self._valid.clear()
        reached = frozenset().union(*(
            self.reached[("bwd", lv, w)] for lv, _, w in tape))
        grads = {k: b[("acc", k)] if k in reached else None
                 for k in self.params}
        rays = tuple(b.get(("g_" + k, 0)) for k in ("o", "d"))
        return grads, rays
