"""The tile graph: conditional CUDA graph nodes for the level skip and
packed width of a frame's tile and of a train microbatch.

Counterpart of the JAX package's ``lax.cond`` chain in its compiled tile
and train step (``raytracer_tpu/core/render.py:336-347`` and
``:413-433``), which XLA evaluates as scalar code inside one program. A
:class:`TileGraph` puts parts, each captured by PyTorch as a graph of its
own (``torch.cuda.CUDAGraph(keep_graph=True)``), into one CUDA graph
(``csrc/tile_graph.cu``), and adds each level's decision as one kernel
node of its own. A tile (``core/tile_program``): level 0, then for each
level ``level_control_kernel`` (:class:`Control`: the branch chosen from
the level's live count on the card, the flags and the level log written,
the conditional handles set) and one IF node per branch, then the finish.
A train microbatch (``core/train_program``): the same for its forward,
the dead level among the branches; its backward graph runs its head, then
``backward_control_kernel`` (:class:`Backward`: every level's handles set
from the flags the forward wrote, in one launch), then its levels' IF
nodes in reverse, then level 0's vjp.

The source is built with nvcc for sm_90a into ``build/`` at first use and
bound through ctypes, as K1 is (``ops/mesh_cuda.py``). Conditional nodes
need CUDA 12.4 or later in the toolkit and the driver, and a PyTorch whose
``CUDAGraph`` keeps its ``cudaGraph_t`` (``keep_graph``, PyTorch 2.8 or
later): :func:`check_support` raises, naming the versions, where either
is missing.

The plain version of ``level_control_kernel`` is :func:`level_control_plain`
(the decision from the branch table as the kernel encodes it,
:func:`branch_codes`); the card's path never calls it. On the CPU the
tile and train programs run it on the buffers the kernel writes
(:func:`level_control_cpu`) and take the body whose flag is set, read on
the host; a train program's backward reads the same flags, which is the
plain version of ``backward_control_kernel``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from raytracer_tpu_torch.ops import mesh_cuda as MC

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "tile_graph.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
MAX_BRANCHES = 5          # four packed widths and the dead level
MAX_LEVELS = 32           # levels of one backward_control_kernel
MIN_CUDA = 12040          # conditional nodes: CUDA 12.4
CODE_WHOLE, CODE_DEAD = 0, -1   # branch codes besides a packed width

_lib_lock = threading.Lock()
_lib = None


def build_library() -> tuple[Path, str]:
    """Compile ``csrc/tile_graph.cu`` into ``build/`` unless already
    built; returns (path, the compiler's log)."""
    return MC.nvcc_build(_CSRC, NVCC_FLAGS, "tile_graph")


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            pp = ctypes.POINTER(ctypes.c_void_p)
            pi = ctypes.POINTER(i)
            lib.tile_graph_versions.argtypes = [pi, pi]
            lib.tile_graph_create.argtypes = [pp]
            lib.tile_graph_add_child.argtypes = [p, p, pp]
            lib.tile_graph_add_control.argtypes = [p, i, pp, pi, p, ll, p,
                                                   p, pp]
            lib.tile_graph_add_backward.argtypes = [p, i, pi, pp, pp, pp]
            lib.tile_graph_node_count.argtypes = [p, pi, pi, pi]
            lib.tile_graph_instantiate.argtypes = [p, pp]
            lib.tile_graph_launch.argtypes = [p, p]
            lib.tile_graph_destroy.argtypes = [p, p]
            for f in ("versions", "create", "add_child", "add_control",
                      "add_backward", "node_count", "instantiate", "launch",
                      "destroy"):
                getattr(lib, f"tile_graph_{f}").restype = i
            _lib = lib
        return _lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"tile graph: {what} failed: CUDA error {err}")


def versions() -> dict:
    """The versions conditional nodes depend on: PyTorch's, the CUDA it
    was built with, the runtime the tile graph's library links and the
    driver's (CUDA versions as 1000 * major + 10 * minor)."""
    rt, drv = ctypes.c_int(), ctypes.c_int()
    _raise_on(_library().tile_graph_versions(ctypes.byref(rt),
                                             ctypes.byref(drv)),
              "cudaRuntimeGetVersion")
    return dict(torch=torch.__version__, torch_cuda=torch.version.cuda,
                runtime=rt.value, driver=drv.value,
                keep_graph=hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"))


def check_support():
    """Raises unless this process can build tile graphs: conditional
    nodes in the runtime and the driver (CUDA 12.4 or later) and a
    PyTorch whose graphs keep their ``cudaGraph_t``. Nothing falls back
    to the host-decided loop."""
    v = versions()
    if (not v["keep_graph"] or v["runtime"] < MIN_CUDA
            or v["driver"] < MIN_CUDA):
        raise RuntimeError(
            f"the tile graph needs CUDA graph conditional nodes (CUDA "
            f"12.4 or later in the runtime and the driver) and "
            f"torch.cuda.CUDAGraph(keep_graph=True) (PyTorch 2.8 or "
            f"later); found PyTorch {v['torch']} built for CUDA "
            f"{v['torch_cuda']}, runtime {v['runtime']}, driver "
            f"{v['driver']}, keep_graph {v['keep_graph']}")
    return v


def branch_codes(branches) -> tuple:
    """A level's branches (``render.level_branches``) as
    ``level_control_kernel`` takes them: a packed width as itself, the
    whole level (None) as :data:`CODE_WHOLE`, the dead level as
    :data:`CODE_DEAD`."""
    return tuple(CODE_WHOLE if b is None else CODE_DEAD
                 if isinstance(b, str) else int(b) for b in branches)


def level_control_plain(live, rows: int, codes):
    """The plain version of ``level_control_kernel``: the decision of a
    level of ``rows`` rays with the branch codes ``codes``
    (:func:`branch_codes`) from its live count ``live`` (an int64 tensor
    of any shape). Returns (flags, log): int32 [..., len(codes)], the
    flag of each branch (a packed width W set when ``live > 0`` and W is
    the narrowest of R/16, R/4, R/2 and R that holds ``live``; the whole
    level when ``live > 0``; the dead level when ``live == 0``), and int32
    [...], the level log's entry (the set branch's code, -1 when none or
    the dead level is set)."""
    alive = live > 0
    r = rows
    width = torch.where(live <= r // 16, r // 16, torch.where(
        live <= r // 4, r // 4, torch.where(live <= r // 2, r // 2, r)))
    flags, log = [], torch.full_like(live, -1)
    for code in codes:
        on = (~alive if code == CODE_DEAD else alive if code == CODE_WHOLE
              else alive & (width == code))
        flags.append(on)
        if code != CODE_DEAD:
            log = torch.where(on, code, log)
    return torch.stack(flags, -1).to(torch.int32), log.to(torch.int32)


def level_control_cpu(live, rows: int, codes, flags, log):
    """A level decided on the CPU as :class:`Control` decides it on the
    card: :func:`level_control_plain`'s flags and log entry written into
    ``flags`` and ``log``, the buffers the kernel writes. Returns the index
    of the set flag, the body whose IF node would run, read on the host
    (None: none is set)."""
    on, entry = level_control_plain(live, rows, codes)
    flags.copy_(on)
    log.copy_(entry)
    on = on.tolist()
    return on.index(1) if 1 in on else None


class Control(NamedTuple):
    """A level decided on the card, a part of :class:`TileGraph`:
    ``level_control_kernel`` reads ``live`` (int64 scalar), writes
    ``flags`` (int32 [len(bodies)]) and ``log`` (an int32 element of the
    level log) and sets the handles of one IF node per body (captured
    graphs), in the order of ``branches`` (``render.level_branches`` of a
    level of ``rows`` rays)."""
    live: torch.Tensor
    rows: int
    branches: tuple
    flags: torch.Tensor
    log: torch.Tensor
    bodies: list


class Backward(NamedTuple):
    """A backward's levels, a part of :class:`TileGraph`: ``levels`` is a
    list of (flags, bodies), in the order they run; one
    ``backward_control_kernel`` sets every level's IF handles from its
    flags (int32 [len(bodies)], written by an earlier launch), then each
    level's IF nodes follow."""
    levels: list


def _check_flags(flags, n):
    if not 1 <= n <= MAX_BRANCHES or tuple(flags.shape) != (n,) \
            or flags.dtype != torch.int32 or not flags.is_cuda \
            or not flags.is_contiguous():
        raise ValueError(f"tile graph: a level wants 1 to {MAX_BRANCHES} "
                         f"bodies and int32 cuda flags [n], got {n} and "
                         f"{flags.dtype} {tuple(flags.shape)}")


def _graphs(bodies):
    return (ctypes.c_void_p * len(bodies))(*(b.raw_cuda_graph()
                                             for b in bodies))


def node_counts(graph) -> dict:
    """The nodes of a captured graph's top level (``CUDAGraph`` kept with
    ``keep_graph=True``, or a :class:`TileGraph`): ``total``, ``kernels``,
    ``children`` (child-graph nodes) and ``other`` (the rest: memory
    copies, and conditional nodes, whose type the runtime does not give;
    see ``tile_graph_node_count``)."""
    raw = (graph.graph if isinstance(graph, TileGraph)
           else graph.raw_cuda_graph())
    total, kernels, children = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _raise_on(_library().tile_graph_node_count(
        raw, ctypes.byref(total), ctypes.byref(kernels),
        ctypes.byref(children)), "cudaGraphGetNodes")
    return dict(total=total.value, kernels=kernels.value,
                children=children.value,
                other=total.value - kernels.value - children.value)


class TileGraph:
    """One instantiated CUDA graph made of captured parts in a chain.

    ``parts``: a list whose items are a ``torch.cuda.CUDAGraph`` captured
    with ``keep_graph=True`` (a child-graph node), a :class:`Control` (a
    level decided on the card) or a :class:`Backward` (levels run on the
    flags of an earlier launch). The parts and the tensors they name must
    outlive the tile graph (a child node is a copy of its graph, but the
    memory its kernels address is the parts' pool and buffers).

    ``launch()`` runs the whole chain on the current stream:
    ``level_control_kernel`` once per :class:`Control`, counted on
    ``level_control_launches`` of this module, and
    ``backward_control_kernel`` once per :class:`Backward`, counted on
    ``backward_control_launches``."""

    def __init__(self, parts):
        lib = _library()
        self.graph, self.exec = ctypes.c_void_p(), ctypes.c_void_p()
        self.controls = self.backwards = 0
        _raise_on(lib.tile_graph_create(ctypes.byref(self.graph)),
                  "cudaGraphCreate")
        last = ctypes.c_void_p()
        for part in parts:
            if isinstance(part, torch.cuda.CUDAGraph):
                _raise_on(lib.tile_graph_add_child(
                    self.graph, part.raw_cuda_graph(), ctypes.byref(last)),
                    "adding a child graph")
            elif isinstance(part, Control):
                self._add_control(lib, part, last)
            elif isinstance(part, Backward):
                self._add_backward(lib, part, last)
            else:
                raise TypeError(f"tile graph: unknown part {part!r}")
        _raise_on(lib.tile_graph_instantiate(self.graph,
                                             ctypes.byref(self.exec)),
                  "cudaGraphInstantiate")

    def _add_control(self, lib, part, last):
        n = len(part.bodies)
        _check_flags(part.flags, n)
        codes = branch_codes(part.branches)
        if len(codes) != n or part.live.dtype != torch.int64 \
                or part.live.numel() != 1 or not part.live.is_cuda \
                or part.log.dtype != torch.int32 or part.log.numel() != 1 \
                or not part.log.is_cuda:
            raise ValueError("tile graph: a level control wants one branch "
                             "per body, an int64 cuda live count and an "
                             "int32 cuda log entry")
        _raise_on(lib.tile_graph_add_control(
            self.graph, n, _graphs(part.bodies), (ctypes.c_int * n)(*codes),
            part.live.data_ptr(), part.rows, part.flags.data_ptr(),
            part.log.data_ptr(), ctypes.byref(last)),
            "adding a level's control and conditional nodes")
        self.controls += 1

    def _add_backward(self, lib, part, last):
        levels = len(part.levels)
        if not 1 <= levels <= MAX_LEVELS:
            raise ValueError(f"tile graph: a backward wants 1 to "
                             f"{MAX_LEVELS} levels, got {levels}")
        for flags, bodies in part.levels:
            _check_flags(flags, len(bodies))
        ns = (ctypes.c_int * levels)(*(len(b) for _, b in part.levels))
        bodies = _graphs([b for _, bs in part.levels for b in bs])
        flags = (ctypes.c_void_p * levels)(*(f.data_ptr()
                                             for f, _ in part.levels))
        _raise_on(lib.tile_graph_add_backward(
            self.graph, levels, ns, bodies, flags, ctypes.byref(last)),
            "adding a backward's control and conditional nodes")
        self.backwards += 1

    def launch(self, device=None):
        """One launch of the graph on ``device``'s current stream."""
        global level_control_launches, backward_control_launches
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(_library().tile_graph_launch(self.exec, stream),
                  "cudaGraphLaunch")
        level_control_launches += self.controls
        backward_control_launches += self.backwards

    def __del__(self):
        if _lib is not None and getattr(self, "graph", None) is not None:
            _lib.tile_graph_destroy(self.graph, self.exec)
            self.graph = self.exec = None


level_control_launches = 0
backward_control_launches = 0


def launch_counts() -> dict:
    """Launches of this module's kernels so far, by kernel."""
    return dict(level_control=level_control_launches,
                backward_control=backward_control_launches)


def reset_launches():
    """Sets this module's launch counts to 0."""
    global level_control_launches, backward_control_launches
    level_control_launches = backward_control_launches = 0
