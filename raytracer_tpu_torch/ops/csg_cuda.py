"""The CSG filter of a root of up to 32 columns in one kernel.

``core/csg.apply_csg`` sets to +inf the hits of a CSG root that the tree's
rules disallow. Its plain versions are ``csg._filter_pairwise`` (an
[R, C, C] table of which hit comes before which, two reductions a node)
and, above ``csg.PAIRWISE_MAX_COLS`` columns, ``csg._filter_sorted``. It
replaces no TPU kernel: the JAX package leaves the filter to XLA.

* :func:`csg_filter` — the hand-written kernel ``csg_filter_kernel`` of
  ``csrc/csg_filter.cu`` (built with nvcc at first use, bound through
  ctypes, as the pattern kernel is): one launch a root, one thread a row,
  each row's hits, their order and the tree's state in registers; it
  reads the whole [R, C] table once and writes a new one, the root's
  columns filtered, the others copied. Bit for bit the plain version's
  result. It has no backward. The launch runs inside the operator
  ``raytracer_torch::csg_filter`` (``torch.library``, a CUDA kernel
  only), so that ``torch.profiler`` files the kernel under an op, and
  with it under the stage mark around the call.
* :func:`pack_plan` — a root's plan as the kernel takes it: its columns
  and, a node, the op and the under and left masks as 32-bit words over
  the root's columns, in one host array. Made once per scene and column
  layout (``csg._root_plans``); None above :data:`MAX_COLS` columns.
* :func:`takes_kernel` — the route: the kernel on a CUDA device where the
  root has a packed plan and no gradient can flow through the filter
  (grad mode off, or the table does not require grad); else the plain
  version, which is also the CPU's.

Launches are counted in :data:`LAUNCHES` ("csg", the kernel's launches;
"csg_plain", the plain versions' evaluations, one a root), which
``mesh_cuda.host_counts`` carries, so the tile and train programs add a
graph's to them at each replay.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path

import numpy as np
import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "csg_filter.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")
# the widest root the kernel takes: a 32-bit mask over its columns
MAX_COLS = 32
_lib_lock = threading.Lock()
_lib = None
_op = None


def build_library() -> tuple[Path, str]:
    """Compile ``csrc/csg_filter.cu`` for sm_90a into ``build/`` unless
    already built; returns (path, the compiler's log)."""
    from raytracer_tpu_torch.ops.mesh_cuda import nvcc_build

    return nvcc_build(_CSRC, NVCC_FLAGS, "csg_filter")


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.csg_filter_launch.argtypes = [p, p, ll, i, p, i, i, i, p, p]
            lib.csg_filter_launch.restype = i
            _lib = lib
        return _lib


def _operator():
    """``torch.ops.raytracer_torch.csg_filter``, defined at first use: a
    launch made inside an op's call is one the profiler can link to it
    (a bare ctypes launch reaches the trace with no op)."""
    global _op
    with _lib_lock:
        if _op is None:
            lib = torch.library.Library("raytracer_torch", "FRAGMENT")
            lib.define("csg_filter(Tensor ts, Tensor plan, Tensor? others, "
                       "int n_nodes) -> Tensor")
            lib.impl("csg_filter", _launch, "CUDA")
            _op = (lib, torch.ops.raytracer_torch.csg_filter.default)
        return _op[1]


def _launch(ts, host, others, n_nodes):
    """The operator's CUDA kernel: a new table from ``ts`` [R, C] and the
    plan's host array ``host`` (:attr:`Plan.host`)."""
    src = ts.contiguous()
    out = torch.empty_like(src)
    if src.shape[0] == 0:
        return out
    n_others = 0 if others is None else others.shape[0]
    err = _library().csg_filter_launch(
        src.data_ptr(), out.data_ptr(), src.shape[0], src.shape[1],
        others.data_ptr() if n_others else None, n_others,
        host.shape[0] - 3 * n_nodes, n_nodes, host.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"csg_filter_kernel launch failed: CUDA error "
                           f"{err}")
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """One root's plan for the kernel. ``host``: int32 on the CPU, the
    root's columns, then each node's op, under word and left word
    (bottom-up), which the launch reads; ``cols`` int32 [cr]: the table's
    column of each root column; ``ops`` int32, ``under`` and ``left``
    uint32 [nodes]: views of ``host``, each node's op and, bit k for root
    column k, the columns in its subtree and in its left child;
    ``n_cols``: the table's columns; ``others``: the table's other
    columns (int32 on the scene's device, None when there are none)."""

    host: torch.Tensor
    cols: np.ndarray
    ops: np.ndarray
    under: np.ndarray
    left: np.ndarray
    n_cols: int
    others: torch.Tensor | None


def pack_plan(cols, nodes, under_bits, left_bits, n_cols, device):
    """The kernel's :class:`Plan` of a root with columns ``cols`` of an
    ``n_cols``-column table: ``nodes`` (op code, bit, root), bottom-up, and
    each root column's uint64 ``under_bits`` and ``left_bits`` (the
    scene's membership masks, as ``csg._node_plan`` reads them). None
    when the root has more than :data:`MAX_COLS` columns."""
    cr, n = len(cols), len(nodes)
    if cr > MAX_COLS:
        return None

    def word(bits, bit):
        return sum(((int(b) >> bit) & 1) << k for k, b in enumerate(bits))

    host = np.concatenate([
        np.asarray(cols, np.int32),
        np.array([op for op, _, _ in nodes], np.int32),
        np.array([word(under_bits, bit) for _, bit, _ in nodes],
                 np.uint32).view(np.int32),
        np.array([word(left_bits, bit) for _, bit, _ in nodes],
                 np.uint32).view(np.int32)])
    others = sorted(set(range(n_cols)) - set(cols))
    return Plan(
        host=torch.from_numpy(host), cols=host[:cr], ops=host[cr:cr + n],
        under=host[cr + n:cr + 2 * n].view(np.uint32),
        left=host[cr + 2 * n:].view(np.uint32), n_cols=n_cols,
        others=(torch.as_tensor(others, dtype=torch.int32, device=device)
                if others else None))


def takes_kernel(ts, plan) -> bool:
    """Whether a root's filter goes to the kernel: on a CUDA device, where
    the root has a packed plan (:func:`pack_plan`: at most
    :data:`MAX_COLS` columns) and no gradient can flow through the
    filter (grad mode off, or ``ts`` does not require grad), since the
    kernel has no backward. Else the plain version: every CPU call, every
    train step that differentiates through a CSG scene, wider roots."""
    if plan is None or ts.device.type != "cuda":
        return False
    return not (torch.is_grad_enabled() and ts.requires_grad)


def csg_filter(ts, plan: Plan):
    """The kernel: a new [R, C] f32 table, ``ts`` with the root's
    disallowed hits set to +inf, bit for bit ``index_copy`` of the plain
    filter's result into ``ts``; ``ts`` is not written. Counted in
    ``LAUNCHES["csg"]``."""
    dev = ts.device
    if dev.type != "cuda":
        raise ValueError(f"csg_filter_kernel runs on cuda, not {dev}")
    if (ts.dtype != torch.float32 or ts.dim() != 2
            or ts.shape[1] != plan.n_cols):
        raise ValueError(f"csg_filter_kernel: ts must be f32 [R, "
                         f"{plan.n_cols}], not {ts.dtype} {tuple(ts.shape)}")
    out = _operator()(ts, plan.host, plan.others, len(plan.ops))
    if ts.shape[0]:
        LAUNCHES["csg"] += 1
    return out


# "csg": the kernel's launches; "csg_plain": the plain filters'
# evaluations (csg._filter_pairwise or _filter_sorted), each a root's
LAUNCHES = dict.fromkeys(("csg", "csg_plain"), 0)


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def launch_counts() -> dict:
    """A copy of :data:`LAUNCHES`."""
    return dict(LAUNCHES)


def add_launches(delta: dict, sign: int = 1):
    """Adds ``sign`` times ``delta`` (holding :func:`launch_counts`' keys)
    to the counters, as ``mesh_cuda.add_launches`` does for K1's."""
    for key in LAUNCHES:
        LAUNCHES[key] += sign * delta[key]
