"""The compiled train step: a microbatch's levels skipped or packed on the
card by conditional nodes, one forward and one backward CUDA graph.

Counterpart of the JAX package's jitted train steps (``make_optax_step``
and ``make_sharded_train_step`` in ``raytracer_tpu/parallel/train.py``,
and the train bench's ``jax.jit(train_step)``), where the forward, its
per-level ``jax.checkpoint`` and the backward are one compiled program and
every level after the first is run or skipped by a ``lax.cond`` on its
live rays, with a ``_dead`` branch (``raytracer_tpu/core/render.py:
413-432``), a packed level's width coming from the ``lax.cond`` chain of
``_packed_shade_level`` (``:338-348``). PyTorch's counterpart of a
compiled program is a CUDA graph, and of ``lax.cond`` a conditional graph
node, as in ``core/tile_program.py`` for the frame. A
:class:`TrainProgram` runs one microbatch of
``parallel.train.render_loss_and_grad`` as two graph launches:

1. the forward graph: level 0; then for each level L from 1 to the limit,
   where the scene spawns, one kernel, ``level_control_kernel``
   (``ops/graph_cuda.Control``), that chooses the level's branch on the
   card from the live count, as ``graph_cuda.level_control_plain``
   does with the dead level among the branches (exactly one set), writes
   the level's flags and its entry of the level log and sets the handles
   of one IF node per branch of ``render.level_branches(...,
   dead=True)``: the widths R/16, R/4, R/2 and R where the level packs,
   else the whole level, and the dead level (``render.dead_step``), which
   passes the image through and writes zero-weight spawns and a live
   count of 0. A body is ``render.level_step`` at its width on level L's
   input buffers, its outputs copied into level L + 1's. Then the loss
   (the MSE of ``render_loss``) of the last level's image and its
   gradient with respect to that image;
2. the backward graph: the parameters' gradient sums set to -0.0; then
   one kernel, ``backward_control_kernel`` (``ops/graph_cuda.Backward``),
   that sets every level's IF handles from the flags the forward wrote;
   then for each level from the limit down to 1 an IF node per branch,
   a body being the vjp of the forward
   body of its width (a dead level's copies the image's gradient through
   and writes zero gradients for its other inputs, adding nothing to the
   sums); then level 0's vjp.

No value reaches the host between the levels or between the two
launches. The step reads the card once, at its end (:meth:`settle`): the
level logs of its microbatches, from which ``levels``, the launch counts
and the parameters the step reached are rebuilt.

Every level has buffers of its own (its inputs, its jitter, the gradients
of its inputs), because the backward of a level reads what its forward
read, and the dead level lets the loss always read the last level's image.
The parts (level 0, every branch of every level forward and backward,
the loss, the head of the backward) are captured
up front, at the first forward, each as a PyTorch graph that keeps its
``cudaGraph_t`` (``keep_graph=True``), and chained by
``ops/graph_cuda.TileGraph``. First each part runs once eagerly on the
program's side stream (K1's shared-memory attribute, cuBLAS and the
sort's scratch initialise there; of a level's branches only the widest
commits its warm-up, since at a width narrower than the live count a
branch computes wrong rays), then it is captured, which runs nothing. The
graphs compute the microbatch.

Memory. Without remat, a forward body's outputs and the tensors autograd
saved for its backward stay allocated (its captured tensors are kept),
and its backward body reads them. They live in a memory pool of that body
alone: in the pool the other parts share, a part captured earlier could
have its temporaries where a later capture keeps such tensors. Every
width of every level keeps its tensors, so the kept memory of a level is
up to (1/16 + 1/4 + 1/2 + 1) of its full-width forward's. That is why a
blend scene's levels, which the tile program packs, run whole here
(``render.level_branches`` with ``keeps``, the default): one body a
level, until a level's bodies can share their kept memory. A forward
overwrites what the previous one saved: each microbatch's backward must
run before the next forward, and :meth:`TrainProgram.forward` raises when
a backward is pending. With ``remat=True`` (the counterpart of
``jax.checkpoint`` per level) the forward bodies keep nothing, and each
backward body recomputes its level and takes its vjp.

Bit-equality with the eager step. A parameter used by several levels gets
its gradient summed over them. The autograd engine of the eager step adds
each contribution as it arrives, the deepest level's first, one at a
time. Each backward body therefore takes the sum so far as the gradient
of a view of the parameter made after the level's ops (an "anchor", the
first node the engine runs), so it adds the level's contributions to it
in the eager order. The sums start at -0.0, the additive identity of
IEEE floats (+0.0 would turn a -0.0 into +0.0), so the first contribution
comes through as it is, as eager's first ``.grad`` does; a table no level
reaches keeps -0.0 and adds nothing to a sum over microbatches. Graphed
and eager steps give the same loss, gradients and updates bit for bit on
the CPU; on cuda the loss is bit-equal and the gradients agree to rounding
(``index_add_`` adds in atomic order there).

Buffers. The parameters live in the program's own leaf tensors (copied
from each step's values by :meth:`TrainProgram.load`), so a train step
that returns a new ``Scene`` does not make a new program: a program is
found again (:func:`program_for`) from what does not change between steps,
the static scene, the frozen tables (the very same tensors), the
parameters' shapes, the microbatch's ray count, ``remat`` and whether the
rays require grad. The random area-light jitter of every level is drawn
by the host into the level's buffers at its whole width before the
forward launch, in level order, as ``render.color_at`` draws it.

Replays run K1 and K1b without the Python launch counters seeing them, so
each part records its launches at capture (taken back off the counters: a
capture launches nothing), and :meth:`settle` adds the launches of the
parts each microbatch ran, read from its level log.

The update is not in a graph: ``train_step``'s SGD and a ``torch.optim``
step run eagerly after the graphed gradient (a few launches per table).

On a CPU scene the program runs the same parts on the same buffers
without capture: the control kernel's plain version writes the same flags
and level log entries (``graph_cuda.level_control_cpu``), and each level's
body, forward and backward, is the one whose flag is set, read on the
host. A card or a PyTorch without conditional nodes raises
(``graph_cuda.check_support``), and so does a capture or launch error;
nothing falls back to a host-decided loop, to the eager step or to the
CPU.
"""

from __future__ import annotations

import contextlib

import torch

from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.ops import graph_cuda as GC
from raytracer_tpu_torch.ops import mesh_cuda as MC
from raytracer_tpu_torch.utils import profiling as P

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
    scene's other tables are the same tensors and its levels take the same
    widths (``render.level_branches``); at most :data:`MAX_PROGRAMS` are
    kept, the least recently used dropped with its graphs' memory
    pools."""
    scene = recombine(params)
    st = scene.static
    rest = tuple(getattr(scene, k) for k in T.ARRAY_FIELDS
                 if k not in params)
    branches = tuple(R.level_branches(st, n) for n in
                     R.level_rows(st, rows, st.recursion_limit))
    key = (st, scene.device, rows, bool(remat), tuple(ray_grad),
           tuple((k, tuple(v.shape), v.dtype) for k, v in params.items()),
           branches)
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
    """A microbatch's forward and backward as two CUDA graphs (see the
    module docstring).

    ``stats``, counted since the program was made: ``captured`` parts, of
    them conditional ``bodies``, seconds spent warming up, capturing and
    chaining them (``capture_s``, the clock of the ``train.build``
    span), graph launches (``replays``: two per
    microbatch) and host ``syncs`` (one per step, :meth:`settle`).
    ``levels``: (level, rays, width) of every level each microbatch of the
    last step ran, microbatch after microbatch, read from the level logs
    (width None: the level ran whole). ``graphs``: the captured parts by
    key (on the CPU, the keys run, with no graph behind them)."""

    def __init__(self, key, recombine, rest):
        static, device, rows, remat, ray_grad, sig, _ = key
        self.key, self.rest = key, rest
        self.static, self.device, self.rows = static, device, rows
        self.remat, self.ray_grad = remat, ray_grad
        self.limit = static.recursion_limit
        self.level_rows = R.level_rows(static, rows, self.limit)
        # the level whose image the loss reads: past the last level that
        # may run, every level having a body, the dead one included
        self.end = len(self.level_rows)
        self.branches = {lv: R.level_branches(static, n, dead=True)
                         for lv, n in enumerate(self.level_rows) if lv}
        self.codes = {lv: GC.branch_codes(b)
                      for lv, b in self.branches.items()}
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
        self._kept = {}           # CPU: the forward bodies' outputs
        self._pending = []        # [log on its way to the host, event,
        #                            whether its backward was launched]
        self._capturing = False
        self.fwd_graph = self.bwd_graph = None
        with torch.no_grad():
            self._put(("o", 0), torch.zeros((rows, 3), device=device,
                                            requires_grad=ray_grad[0]))
            self._put(("d", 0), torch.zeros((rows, 3), device=device,
                                            requires_grad=ray_grad[1]))
            self._put(("w", 0), torch.ones((rows, 3), device=device))
            self._put(("img", 0), torch.zeros((rows, 3), device=device))
            for k, p in self.params.items():
                self._put(("acc", k), torch.zeros_like(p))
            self._put(("log",), torch.zeros(len(self.level_rows),
                                            dtype=torch.int32, device=device))
            for level, branches in self.branches.items():
                self._put(("flags", level), torch.zeros(
                    len(branches), dtype=torch.int32, device=device))
        self.log = self.bufs[("log",)]
        if self.capture:
            self.versions = GC.check_support()
            # the pool the parts' temporaries share; a forward body whose
            # tensors are kept gets one of its own (``pools``)
            self.pool = torch.cuda.graph_pool_handle()
            self.pools = [self.pool]
            self.stream = torch.cuda.Stream(device)
        self.stats = dict(captured=0, bodies=0, capture_s=0.0, replays=0,
                          syncs=0)
        self._levels = []

    @property
    def levels(self):
        """(level, rays, width) of every level each microbatch of the last
        step ran (see the class docstring), the logs on their way read
        first (:meth:`settle`)."""
        if any(done for _, _, done in self._pending):
            self.settle()
        return self._levels

    # -- buffers -----------------------------------------------------------
    def _put(self, name, value):
        """``value`` into buffer ``name``, made on first use with
        ``value``'s shape, dtype and requires_grad."""
        buf = self._make(name, value)
        with torch.no_grad():
            buf.copy_(value)

    def _make(self, name, value):
        """Buffer ``name``, made (zeroed) on first use with ``value``'s
        shape, dtype and requires_grad, which a later value must share."""
        buf = self.bufs.get(name)
        grad = value.requires_grad
        if buf is None:
            if self._capturing:
                raise RuntimeError(f"train program: buffer {name} first "
                                   f"made inside a capture")
            buf = self.bufs[name] = torch.zeros(
                value.shape, dtype=value.dtype,
                device=self.device).requires_grad_(grad)
        elif (buf.shape, buf.dtype, buf.requires_grad) != (
                value.shape, value.dtype, grad):
            raise RuntimeError(f"train program: buffer {name} is "
                               f"{tuple(buf.shape)} {buf.dtype} grad "
                               f"{buf.requires_grad}, given "
                               f"{tuple(value.shape)} {value.dtype} {grad}")
        return buf

    def _commit(self, outs: dict):
        for name, v in outs.items():
            self._put(name, v)

    def _grad_of(self, k, level):
        """The buffer of the gradient of level ``level``'s input ``k``."""
        name = ("g_" + k, level)
        if name not in self.bufs:
            self._make(name, self.bufs[(k, level)].detach())
        return self.bufs[name]

    def _jitter(self, level):
        """Level ``level``'s jitter buffers, at its whole width."""
        if not R.draws_jitter(self.static):
            return None
        rows = self.level_rows[level]
        out = []
        for ai, (us, vs) in enumerate(self.static.area_steps):
            name = ("jitter", level, ai)
            if name not in self.bufs:
                self._make(name, torch.empty((rows, us * vs, 4), dtype=F32,
                                             device=self.device))
            out.append(self.bufs[name])
        return tuple(out)

    def _flags(self, level):
        return self.bufs[("flags", level)]

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

    # -- the parts ---------------------------------------------------------
    def _outputs(self, level, width):
        """Level ``level``'s outputs from its input buffers, with grad."""
        b = self.bufs
        with torch.enable_grad():
            return R.level_step(
                self.scene, level, self.limit, b[("o", level)],
                b[("d", level)], b[("w", level)], b[("img", level)],
                self._jitter(level), width=width)

    def _named(self, level, outs):
        """Level ``level``'s outputs by the buffer names of level + 1."""
        return {("live",) if k == "live" else (k, level + 1): v
                for k, v in outs.items()}

    def _fwd(self, level, width):
        """Forward body ``width`` of ``level``: its outputs (by output
        name, with grad). Level 0 writes the level log: 0 for itself, -1
        (skipped) for every later level, whose control kernel (on the
        CPU, :meth:`_forward_cpu`) writes its entry."""
        if level == 0:
            self.log.fill_(-1)
            self.log[0].fill_(0)
        return self._outputs(level, width)

    def _fwd_commit(self, level):
        return lambda outs: self._commit(self._named(level, outs))

    def _dead(self, level):
        """The dead body of ``level`` (``render.dead_step``), by buffer
        name."""
        return self._named(level, R.dead_step(
            self.static, level, self.limit, self.level_rows[level],
            self.bufs[("img", level)]))

    def _dead_commit(self, outs):
        """The dead body's outputs into the next level's buffers. A spawn
        buffer no body has made yet (on the CPU, where buffers are made as
        the levels first run) is left unmade: no level reads it before a
        live body makes it."""
        for name, v in outs.items():
            buf = self.bufs.get(name)
            if buf is None:
                if name[0] in ("o", "d", "w"):
                    continue
                buf = self._make(name, v)
            with torch.no_grad():
                buf.copy_(v)

    def _loss(self):
        """The MSE of the last level's image against the target, and its
        gradient with respect to that image."""
        img = self.bufs[("img", self.end)]
        with torch.enable_grad():
            loss = torch.mean((img - self.bufs[("target",)]) ** 2)
            g_img = (torch.autograd.grad(loss, img)[0] if img.requires_grad
                     else torch.zeros_like(img))
        return {("loss",): loss.detach(), ("g_img", self.end): g_img}

    def _head(self):
        """The backward's head: the parameters' gradient sums set to
        -0.0, the additive identity (see the module docstring)."""
        return {("acc", k): torch.full_like(p, -0.0)
                for k, p in self.params.items()}

    def _bwd(self, level, width, outs):
        """The vjp of level ``level`` at ``width``: the gradients of its
        inputs and the parameters' gradient sums, by buffer name.
        ``outs``: its forward's outputs (None: recompute them, remat)."""
        b = self.bufs
        if outs is None:
            outs = self._outputs(level, width)
        diff = [(outs[k], self._grad_of(k, level + 1)) for k in DIFF
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

    def _bwd_body(self, level, width):
        """Backward body ``width`` of ``level`` on cuda: the vjp of its
        forward body's kept outputs (recomputed with remat), or the dead
        body's backward."""
        if width == R.DEAD:
            return self._dead_bwd(level)
        return self._bwd(level, width, None if self.remat
                         else self.graphs[("fwd", level, width)][2])

    def _dead_bwd(self, level):
        """The backward of the dead body of ``level``: the image's
        gradient copied through, zero gradients for its other inputs, the
        parameters' sums untouched."""
        self.reached.setdefault(("bwd", level, R.DEAD), frozenset())
        out = {}
        for k in DIFF:
            buf = self.bufs.get((k, level))
            if buf is not None and buf.requires_grad:
                out[("g_" + k, level)] = (
                    self._grad_of("img", level + 1) if k == "img"
                    else torch.zeros_like(buf))
        return out

    # -- capture -----------------------------------------------------------
    def _capture(self, key, fn, commit, keep=False):
        """Captures ``fn`` with its results committed (a graph that keeps
        its ``cudaGraph_t``), in a memory pool of its own with ``keep``,
        whose captured outputs are then kept; records its launches."""
        before = MC.host_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        pool = self.pool
        if keep:
            pool = torch.cuda.graph_pool_handle()
            self.pools.append(pool)
        self._capturing = True
        try:
            graph.capture_begin(pool=pool)
            try:
                outs = fn()
                commit(outs)
            finally:
                graph.capture_end()
        finally:
            self._capturing = False
        counts = {k: v - before[k] for k, v in MC.host_counts().items()}
        MC.add_launches(counts, -1)
        self.graphs[key] = (graph, counts, outs if keep else None)
        self.stats["captured"] += 1
        self.stats["bodies"] += key[0] in ("fwd", "bwd") and key[1] > 0

    def _build(self):
        """Warms up, captures and chains every part (on the side stream):
        the forward and the backward graph."""
        levels = range(1, self.end)
        with P.timed("train.build") as sp:
            with P.span("capture.warmup"):
                self._warm_up(levels)
            with P.span("capture.record"):
                self._capture_parts(levels)
            with P.span("capture.chain"):
                self._chain(levels)
        self.stats["capture_s"] += sp.seconds

    def _warm_up(self, levels):
        # warm-up (the graphs compute the step anew): level 0 commits, and
        # of a level's branches the widest, which holds every live ray, so
        # that the next level warms up on real rays; the others only make
        # their outputs' buffers
        outs0 = self._fwd(0, None)
        self._fwd_commit(0)(outs0)
        for level in levels:
            *live, _ = self.branches[level]
            for width in live:
                outs = self._fwd(level, width)
                named = self._named(level, outs)
                for name, v in named.items():
                    self._make(name, v)
                for name, v in self._bwd(level, width,
                                         None if self.remat else outs).items():
                    self._make(name, v)
                if width == live[-1]:
                    self._commit(named)
                del outs, named
            self._dead(level)
            self._dead_bwd(level)
        self._commit(self._loss())
        self._commit(self._head())
        self._commit(self._bwd(0, None, None if self.remat else outs0))
        del outs0

    def _capture_parts(self, levels):
        keep = not self.remat
        self._capture(("fwd", 0, None), lambda: self._fwd(0, None),
                      self._fwd_commit(0), keep)
        for level in levels:
            for width in self.branches[level]:
                if width == R.DEAD:
                    self._capture(("fwd", level, width),
                                  lambda level=level: self._dead(level),
                                  self._dead_commit)
                else:
                    self._capture(("fwd", level, width),
                                  lambda level=level, width=width:
                                  self._fwd(level, width),
                                  self._fwd_commit(level), keep)
        self._capture(("loss",), self._loss, self._commit)
        self._capture(("head",), self._head, self._commit)
        for level in [*reversed(levels), 0]:
            for width in self.branches.get(level, (None,)):
                self._capture(("bwd", level, width),
                              lambda level=level, width=width:
                              self._bwd_body(level, width), self._commit)

    def _chain(self, levels):
        g = self.graphs
        fwd = [g[("fwd", 0, None)][0]]
        for level in levels:
            fwd.append(GC.Control(
                self.bufs[("live",)], self.level_rows[level],
                self.branches[level], self._flags(level), self.log[level],
                [g[("fwd", level, w)][0] for w in self.branches[level]]))
        bwd = [g[("head",)][0]]
        if levels:
            bwd.append(GC.Backward(
                [(self._flags(level), [g[("bwd", level, w)][0]
                                       for w in self.branches[level]])
                 for level in reversed(levels)]))
        fwd.append(g[("loss",)][0])
        bwd.append(g[("bwd", 0, None)][0])
        self.fwd_graph = GC.TileGraph(fwd)
        self.bwd_graph = GC.TileGraph(bwd)

    # -- running -----------------------------------------------------------
    def _forward_cpu(self):
        """The forward on the CPU: the parts in order, each level decided
        by the control kernel's plain version, its flags read on the
        host."""
        levels = range(1, self.end)
        for level in [0, *levels]:
            width = None
            if level:
                width = self.branches[level][GC.level_control_cpu(
                    self.bufs[("live",)], self.level_rows[level],
                    self.codes[level], self._flags(level), self.log[level])]
            self.graphs.setdefault(("fwd", level, width), None)
            if width == R.DEAD:
                self._dead_commit(self._dead(level))
                continue
            outs = self._fwd(level, width)
            self._fwd_commit(level)(outs)
            if not self.remat:
                self._kept[level] = outs
        self._commit(self._loss())
        self.graphs.setdefault(("loss",), None)

    def _backward_cpu(self):
        """The backward on the CPU: the parts in reverse order, each
        level's body chosen by the flags its forward wrote."""
        self._commit(self._head())
        for level in [*reversed(range(1, self.end)), 0]:
            width = (self.branches[level][self._flags(level).tolist().index(1)]
                     if level else None)
            self.graphs.setdefault(("bwd", level, width), None)
            self._commit(self._dead_bwd(level) if width == R.DEAD
                         else self._bwd(level, width, self._kept.get(level)))
        self._kept.clear()

    def timing_event(self):
        """A timing CUDA event recorded on the program's stream after the
        caller's work so far (the caller's later work waits for it)."""
        event = torch.cuda.Event(enable_timing=True)
        with self._side():
            event.record()
        return event

    def load(self, params: dict):
        """Copies the step's parameter values into the program's."""
        with self._side(), torch.no_grad():
            for k, p in self.params.items():
                p.copy_(params[k])

    def forward(self, origins, directions, target, generator=None):
        """Enqueues one microbatch's forward, one graph launch on cuda (the
        first builds the program's graphs): the loss, a buffer of the
        program valid until the next forward. Reads nothing from the card.
        Raises while the previous forward's backward is pending: its
        graphs would overwrite what that backward reads."""
        if self._pending and not self._pending[-1][2]:
            raise RuntimeError(
                "train program: a forward launched before the backward of "
                "the previous one; call backward() first")
        if R.draws_jitter(self.static):
            generator = R._seeded(generator, self.device)
        with self._side():
            self._put(("o", 0), origins)
            self._put(("d", 0), directions)
            self._put(("target",), target)
            for level, rows in enumerate(self.level_rows):
                R.draw_jitter(self.scene, rows, generator,
                              out=self._jitter(level))
            if not self.capture:
                self._forward_cpu()
            else:
                if self.fwd_graph is None:
                    self._build()
                self.fwd_graph.launch(self.device)
                self.stats["replays"] += 1
            self._send_log()
        return self.bufs[("loss",)]

    def _send_log(self):
        """Starts the copy of the forward's level log to the host, read by
        :meth:`settle`."""
        if not self.capture:
            self._pending.append([self.log.clone(), None, False])
            return
        host = torch.empty(self.log.shape, dtype=self.log.dtype,
                           pin_memory=True)
        host.copy_(self.log, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._pending.append([host, done, False])

    def backward(self):
        """Enqueues the pending forward's backward, one graph launch on
        cuda: (the parameters' gradient sums by name, -0.0 for a table the
        microbatch did not reach; the gradients of the origins and the
        directions, None where they do not require grad). Buffers of the
        program, valid until the next backward. Which tables the step
        reached, :meth:`settle` says."""
        if not self._pending or self._pending[-1][2]:
            raise RuntimeError("train program: backward() without a "
                               "pending forward")
        with self._side():
            if not self.capture:
                self._backward_cpu()
            else:
                self.bwd_graph.launch(self.device)
                self.stats["replays"] += 1
        self._pending[-1][2] = True
        b = self.bufs
        grads = {k: b[("acc", k)] for k in self.params}
        rays = tuple(b.get(("g_" + k, 0)) for k in ("o", "d"))
        return grads, rays

    def settle(self) -> frozenset:
        """The step's one read of the card: waits for the level logs of the
        microbatches whose backward was launched, rebuilds ``levels`` from
        them, adds the launches of the parts they ran to the counters, and
        returns the names of the parameters they reached (an eager leaf's
        ``.grad`` stays None for the others)."""
        done = [p for p in self._pending if p[2]]
        self._pending = [p for p in self._pending if not p[2]]
        if done and done[-1][1] is not None:
            done[-1][1].synchronize()     # the stream's later events
        self.stats["syncs"] += 1
        self._levels, reached = [], set()
        for log, _, _ in done:
            log = log.tolist()
            self._count(("fwd", 0, None), ("loss",), ("head",),
                        ("bwd", 0, None))
            self._levels.append((0, self.rows, None))
            reached |= self.reached[("bwd", 0, None)]
            for level in range(1, self.end):
                width = R.DEAD if log[level] < 0 else log[level] or None
                self._count(("fwd", level, width), ("bwd", level, width))
                reached |= self.reached[("bwd", level, width)]
                if width != R.DEAD:
                    self._levels.append((level, self.level_rows[level],
                                         width))
        return frozenset(reached)

    def _count(self, *keys):
        if self.capture:
            for key in keys:
                MC.add_launches(self.graphs[key][1])
