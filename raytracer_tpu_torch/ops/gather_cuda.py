"""table_gather: a small table's rows for every ray, with a deterministic
gradient.

Counterpart of ``raytracer_tpu/core/intersect.py::table_gather`` (XLA, not
Pallas), through which the JAX package reads every per-primitive table:
transforms, normal matrices, material rows, pattern and UV tables,
refractive indices and shadow flags. Its TPU routes (a masked reduce for
at most 32 rows, a one-hot product up to 1024) are not carried over; both
compute ``table[idx]``, and both differentiate to a dense sum over the
rays that read each row.

* :func:`table_gather` — on a CUDA tensor the hand-written kernels of
  ``csrc/table_gather.cu`` (built with nvcc at first use, bound through
  ctypes, as K1 is): the forward an exact copy of rows (a unit a thread
  up to 1 MB of output, else a CTA's span of rows as 16-byte stores, a
  small table staged in shared memory); the backward a reduction in a
  fixed order in one launch for tables of up to several hundred rows, an
  exact integer sum on a fixed-point scale for larger ones (an image's
  texels), so two calls give the same bits, eagerly or in a CUDA graph
  replay. On a CPU tensor, :func:`table_gather_plain`.
  Nothing else selects the route, and nothing falls back.
* :func:`table_gather_plain` — ``table[idx]`` forward and
  ``index_add_`` backward, which adds in index order on the CPU.

PyTorch's own backward of ``table[idx]`` (``index_put_`` with accumulate)
walks each row's duplicate indices one after another in one warp: with a
train batch on five primitives, a few hundred thousand rays in a chain.

Out-of-range indices are clamped to the table, in both versions, as the
JAX package's gather clamps them.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "table_gather.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib_lock = threading.Lock()
_lib = None


def build_library() -> tuple[Path, str]:
    """Compile ``csrc/table_gather.cu`` for sm_90a into ``build/`` unless
    already built; returns (path, the compiler's log)."""
    from raytracer_tpu_torch.ops.mesh_cuda import nvcc_build

    return nvcc_build(_CSRC, NVCC_FLAGS, "table_gather")


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.table_gather_workspace.argtypes = [ll, ll, ll]
            lib.table_gather_workspace.restype = ll
            lib.table_gather_fixed.argtypes = [ll, ll, ll]
            lib.table_gather_fixed.restype = i
            lib.table_gather_forward.argtypes = [p, p, i, p, ll, ll, ll, i, p]
            lib.table_gather_forward.restype = i
            lib.table_gather_backward.argtypes = [p, p, i, p, p, ll, ll, ll,
                                                  p, p]
            lib.table_gather_backward.restype = i
            _lib = lib
        return _lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _index(idx, g):
    """``idx`` contiguous; raises unless it is int32 or int64, and on an
    empty table that something indexes."""
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"table_gather: int32 or int64 indices, not "
                         f"{idx.dtype}")
    if g == 0 and idx.numel():
        raise ValueError("table_gather: an empty table has no row to read")
    return idx.contiguous()


def gather_forward_plain(table, idx):
    """``table[idx]`` with the indices clamped to the table."""
    return table[idx.clamp(0, max(table.shape[0] - 1, 0))]


def gather_backward_plain(grad, idx, g):
    """[g, *rest] f32: the rows of ``grad`` [*idx, *rest] summed by index
    (``index_add_``: in index order on the CPU, in atomic order on
    cuda)."""
    rest = grad.shape[idx.dim():]
    flat = grad.reshape(idx.numel(), -1)
    out = torch.zeros((g, flat.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    out.index_add_(0, idx.reshape(-1).clamp(0, max(g - 1, 0)), flat)
    return out.reshape((g, *rest))


def gather_forward(table, idx, out=None):
    """The forward kernel: ``table[idx]``, an exact copy of rows of any
    element type, for a CUDA table and int32 or int64 indices (counted in
    ``LAUNCHES["gather"]``). ``out``: where to write, a contiguous tensor of
    the result's shape and type at any address (by default a new one)."""
    g = table.shape[0]
    idx = _index(idx, g)
    if table.device != idx.device or table.device.type != "cuda":
        raise ValueError(f"table_gather: want both on one CUDA device, got "
                         f"{table.device} and {idx.device}")
    table = table.contiguous()
    shape = (*idx.shape, *table.shape[1:])
    if out is None:
        out = torch.empty(shape, dtype=table.dtype, device=table.device)
    elif (tuple(out.shape) != shape or out.dtype != table.dtype
          or out.device != table.device or not out.is_contiguous()):
        raise ValueError(f"table_gather: out must be a contiguous "
                         f"{table.dtype} {shape} on {table.device}")
    n = idx.numel()
    row_bytes = table.numel() // max(g, 1) * table.element_size()
    if n == 0 or row_bytes == 0:
        return out
    unit = 4 if (row_bytes % 4 == 0 and table.data_ptr() % 4 == 0
                 and out.data_ptr() % 4 == 0) else 1
    if g * (row_bytes // unit) >= 2 ** 31:
        raise ValueError(f"table_gather: a table of {g} rows of {row_bytes} "
                         f"bytes is over 2^31 {unit}-byte units")
    err = _library().table_gather_forward(
        table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        out.data_ptr(), n, g, row_bytes, unit,
        torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(err, "table_gather")
    LAUNCHES["gather"] += 1
    return out


def gather_backward(grad, idx, g):
    """The backward kernels: [g, *rest] f32, the rows of ``grad``
    [*idx, *rest] f32 summed by index, by the route the table's size picks
    (``csrc/table_gather.cu``); each kernel launched is counted in
    :data:`LAUNCHES`. Deterministic: the same inputs give the same
    bits."""
    idx = _index(idx, g)
    rest = grad.shape[idx.dim():]
    if grad.dtype != torch.float32 or grad.device != idx.device \
            or grad.device.type != "cuda" or tuple(grad.shape[:idx.dim()]) \
            != tuple(idx.shape):
        raise ValueError(f"table_gather backward: want an f32 CUDA gradient "
                         f"of shape [*idx, ...], got {grad.dtype} "
                         f"{tuple(grad.shape)} on {grad.device} for indices "
                         f"{tuple(idx.shape)}")
    grad = grad.contiguous()
    n = idx.numel()
    k = grad.numel() // max(n, 1)
    out = torch.empty((g, *rest), dtype=torch.float32, device=grad.device)
    if n == 0 or k == 0 or g == 0:
        return out.zero_()
    if n >= 2 ** 31 or g >= 2 ** 32 - 1:
        raise ValueError(f"table_gather backward: at most 2^31 - 1 indices "
                         f"and 2^32 - 2 rows, not {n} and {g}")
    lib = _library()
    words = lib.table_gather_workspace(n, g, k)
    work = torch.empty(words, dtype=torch.float32, device=grad.device) \
        if words else out
    launched = (ctypes.c_int * len(BACKWARD_KERNELS))()
    err = lib.table_gather_backward(
        grad.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        out.data_ptr(), work.data_ptr(), n, g, k,
        torch.cuda.current_stream(grad.device).cuda_stream, launched)
    for key, count in zip(BACKWARD_KERNELS, launched):
        LAUNCHES[key] += count
    _raise_on(err, "table_gather backward")
    return out


# the kernels' launch counters, by kernel: the forward's, then the
# backward's in the order of the C entry's counts
BACKWARD_KERNELS = ("gather_grad", "gather_scale", "gather_add",
                    "gather_finish")
LAUNCHES = dict.fromkeys(("gather", *BACKWARD_KERNELS), 0)


class TableGather(torch.autograd.Function):
    """``apply(table, idx, plain)``: ``table[idx]`` whose gradient is the
    sum of the output's gradient rows by index. ``plain=False``: the
    kernels (:func:`gather_forward`, :func:`gather_backward`); ``True``:
    their plain versions."""

    @staticmethod
    def forward(ctx, table, idx, plain):
        ctx.save_for_backward(idx)
        ctx.plain, ctx.rows = plain, table.shape[0]
        return (gather_forward_plain if plain else gather_forward)(table,
                                                                   idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        back = gather_backward_plain if ctx.plain else gather_backward
        return back(grad, idx, ctx.rows), None, None


def _differentiated(table):
    return table.requires_grad and torch.is_grad_enabled()


def table_gather_plain(table, idx):
    """:func:`table_gather` in plain torch: ``table[idx]`` (indices
    clamped), and for a table that requires grad an ``index_add_``
    backward."""
    if _differentiated(table):
        return TableGather.apply(table, idx, True)
    return gather_forward_plain(table, idx)


def table_gather(table, idx):
    """``table[idx]`` for a table [G, *rest] and indices of any integer
    shape -> [*idx, *rest]. A CUDA table launches the kernels of
    ``csrc/table_gather.cu`` (the backward too, where the table requires
    grad); a CPU table takes :func:`table_gather_plain`. Build and launch
    errors propagate."""
    if table.device.type == "cpu":
        return table_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"table_gather runs on cuda or cpu, not "
                         f"{table.device}")
    if _differentiated(table):
        return TableGather.apply(table, idx, False)
    return gather_forward(table, idx)


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def launch_counts() -> dict:
    """The kernels' launch counters (a copy of :data:`LAUNCHES`): "gather"
    (the forward), "gather_grad" (the backward's tile route),
    "gather_scale", "gather_add" and "gather_finish" (its fixed-point
    route)."""
    return dict(LAUNCHES)


def add_launches(delta: dict, sign: int = 1):
    """Adds ``sign`` times ``delta`` (holding :func:`launch_counts`' keys)
    to the counters, as ``mesh_cuda.add_launches`` does for K1's."""
    for key in LAUNCHES:
        LAUNCHES[key] += sign * delta[key]
