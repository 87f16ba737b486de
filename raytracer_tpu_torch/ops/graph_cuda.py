"""The tile graph: conditional CUDA graph nodes for the level skip and
packed width of a frame's tile and of a train microbatch.

Counterpart of the JAX package's ``lax.cond`` chain in its compiled tile
and train step (``raytracer_tpu/core/render.py:338-348`` and
``:413-433``). A :class:`TileGraph` puts parts, each captured by PyTorch
as a graph of its own (``torch.cuda.CUDAGraph(keep_graph=True)``), into
one CUDA graph (``csrc/tile_graph.cu``). A tile (``core/tile_program``):
level 0, then for each level its predicates, the kernel
``set_conditionals_kernel`` that copies the predicates' flags into the
conditional handles, and one IF node per branch, then the finish. A train
microbatch (``core/train_program``): the same for its forward, the dead
level among the branches, and a backward graph whose levels, in reverse,
read the flags the forward wrote.

The source is built with nvcc for sm_90a into ``build/`` at first use and
bound through ctypes, as K1 is (``ops/mesh_cuda.py``). Conditional nodes
need CUDA 12.4 or later in the toolkit and the driver, and a PyTorch whose
``CUDAGraph`` keeps its ``cudaGraph_t`` (``keep_graph``, PyTorch 2.8 or
later): :func:`check_support` raises, naming the versions, where either
is missing.

The plain version of ``set_conditionals_kernel`` is the host's choice of
branch, ``core/render.taken_branch`` of the same flags, which the tile
and train programs take on the CPU.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from raytracer_tpu_torch.ops import mesh_cuda as MC

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "tile_graph.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
MAX_BRANCHES = 5          # four packed widths and the dead level
MIN_CUDA = 12040          # conditional nodes: CUDA 12.4

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
            p, i = ctypes.c_void_p, ctypes.c_int
            pp = ctypes.POINTER(ctypes.c_void_p)
            lib.tile_graph_versions.argtypes = [ctypes.POINTER(i),
                                                ctypes.POINTER(i)]
            lib.tile_graph_create.argtypes = [pp]
            lib.tile_graph_add_child.argtypes = [p, p, pp]
            lib.tile_graph_add_level.argtypes = [p, i, pp, p, pp]
            lib.tile_graph_instantiate.argtypes = [p, pp]
            lib.tile_graph_launch.argtypes = [p, p]
            lib.tile_graph_destroy.argtypes = [p, p]
            for f in ("versions", "create", "add_child", "add_level",
                      "instantiate", "launch", "destroy"):
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


class TileGraph:
    """One instantiated CUDA graph made of captured parts in a chain.

    ``parts``: a list whose items are either a ``torch.cuda.CUDAGraph``
    captured with ``keep_graph=True`` (a child-graph node) or a level,
    ``(flags, bodies)``: an int32 CUDA tensor of ``len(bodies)`` flags,
    written by an earlier part, and the branch graphs, each the body of
    one IF node run where its flag is set. The parts and ``flags`` must
    outlive the tile graph (a child node is a copy of its graph, but the
    memory its kernels address is the parts' pool and buffers).

    ``launch()`` runs the whole chain on the current stream:
    ``set_conditionals_kernel`` once per level, counted on
    ``set_conditionals_launches`` of this module."""

    def __init__(self, parts):
        lib = _library()
        self.graph, self.exec = ctypes.c_void_p(), ctypes.c_void_p()
        self.levels = 0
        _raise_on(lib.tile_graph_create(ctypes.byref(self.graph)),
                  "cudaGraphCreate")
        last = ctypes.c_void_p()
        for part in parts:
            if isinstance(part, torch.cuda.CUDAGraph):
                _raise_on(lib.tile_graph_add_child(
                    self.graph, part.raw_cuda_graph(), ctypes.byref(last)),
                    "adding a child graph")
                continue
            flags, bodies = part
            n = len(bodies)
            if not 1 <= n <= MAX_BRANCHES or tuple(flags.shape) != (n,) \
                    or flags.dtype != torch.int32 or not flags.is_cuda:
                raise ValueError(f"tile graph: a level wants 1 to "
                                 f"{MAX_BRANCHES} bodies and int32 cuda "
                                 f"flags [n], got {n} and "
                                 f"{flags.dtype} {tuple(flags.shape)}")
            arr = (ctypes.c_void_p * n)(*(b.raw_cuda_graph()
                                          for b in bodies))
            _raise_on(lib.tile_graph_add_level(
                self.graph, n, arr, flags.data_ptr(), ctypes.byref(last)),
                "adding a level's conditional nodes")
            self.levels += 1
        _raise_on(lib.tile_graph_instantiate(self.graph,
                                             ctypes.byref(self.exec)),
                  "cudaGraphInstantiate")

    def launch(self, device=None):
        """One launch of the graph on ``device``'s current stream."""
        global set_conditionals_launches
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(_library().tile_graph_launch(self.exec, stream),
                  "cudaGraphLaunch")
        set_conditionals_launches += self.levels

    def __del__(self):
        if _lib is not None and getattr(self, "graph", None) is not None:
            _lib.tile_graph_destroy(self.graph, self.exec)
            self.graph = self.exec = None


set_conditionals_launches = 0
