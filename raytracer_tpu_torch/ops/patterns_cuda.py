"""The base colour of a level's shading points in one kernel.

A level body's pattern stage (``render.base_color_of``): each shading point's
pattern colour, or its material's where the point's primitive has no
pattern. Its plain version, ``render.base_color_plain``, is
``core/patterns.pattern_color`` (every pattern kind for every row,
where-selected by kind: 304 PyTorch kernels a level body on the card)
and a ``torch.where`` on the pattern id. It replaces no TPU kernel: the JAX
package leaves the chain to XLA, which fuses it.

* :func:`pattern_base_color` — the hand-written kernel
  ``pattern_color_kernel`` of ``csrc/patterns.cu`` (built with nvcc at
  first use, bound through ctypes, as K1 and table_gather are): one launch,
  one thread a row, each row only its own pattern kind's arithmetic, bit
  for bit the plain version's result on the card. It has no backward.
* :func:`takes_kernel` — the route: the kernel on a CUDA device where no
  gradient can flow through the stage (grad mode off, or no input that
  requires grad); else the plain version, which is also the CPU's.

Launches are counted in :data:`LAUNCHES` ("pattern", the kernel;
"pattern_plain", the plain version's evaluations), which
``mesh_cuda.host_counts`` carries, so the tile and train programs add a
graph's to them at each replay.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from raytracer_tpu_torch.core import types as T

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "patterns.cu"
# the plain chain's rounding: no contracted multiply-add (its only fused
# ones, mat3_apply's, are fmaf in the source), IEEE division and sqrt
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")
# a division by a Python float is, on the card, a product with the f32
# reciprocal of the f32 divisor (PyTorch's div_true kernel)
PI = 3.14159265358979323846
INV_2PI = float(np.float32(1.0) / np.float32(2.0 * PI))
INV_PI = float(np.float32(1.0) / np.float32(PI))

# the scene's pattern tables, in the C entry's order, with their types
TABLES = (("pat_kind", torch.int32), ("pat_a", torch.float32),
          ("pat_b", torch.float32), ("pat_inv", torch.float32),
          ("pat_map", torch.int32), ("pat_uv", torch.int32),
          ("uv_kind", torch.int32), ("uv_wh", torch.float32),
          ("uv_colors", torch.float32), ("uv_image", torch.int32),
          ("image_wh", torch.int32), ("images", torch.float32))
_lib_lock = threading.Lock()
_lib = None


def build_library() -> tuple[Path, str]:
    """Compile ``csrc/patterns.cu`` for sm_90a into ``build/`` unless
    already built; returns (path, the compiler's log)."""
    from raytracer_tpu_torch.ops.mesh_cuda import nvcc_build

    return nvcc_build(_CSRC, NVCC_FLAGS, "patterns")


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
            lib.pattern_color_launch.argtypes = [
                p, p, ll, i, i, p, ll, p, ll, *[p] * len(TABLES), i, i, i, i,
                i, f, f, p]
            lib.pattern_color_launch.restype = i
            _lib = lib
        return _lib


def takes_kernel(scene, over, rows, mat_rows) -> bool:
    """Whether a level's base colour goes to the kernel: on a CUDA device,
    where no gradient can flow through it (grad mode off, or none of the
    points, the shading rows, the material rows and the pattern tables
    requires grad), since the kernel has no backward. Else the plain
    version: every CPU call, and every train step that differentiates the
    points (a pose) or the tables."""
    if over.device.type != "cuda":
        return False
    if not torch.is_grad_enabled():
        return True
    return not any(x.requires_grad for x in (
        over, rows, mat_rows, *(getattr(scene, k) for k, _ in TABLES)))


def pattern_base_color(scene, over, rows, mat_rows):
    """The kernel: [R, 3] f32, the base colour of R shading points, bit
    for bit ``render.base_color_plain``'s on the card. ``over`` [R, 3] f32
    the points; ``rows`` [R, types.SHADE_NCOLS] f32 the shading rows
    ``shade_level`` gathers (read through their row stride: the inverse
    transform in columns ``types.SHADE_INV``, the pattern id in
    ``types.SHADE_PAT_ID``, both passed to the kernel); ``mat_rows``
    [R, >= 3] f32 the material rows (the colour in columns 0-2). Counted
    in
    ``LAUNCHES["pattern"]``."""
    r = over.shape[0]
    dev = over.device
    if dev.type != "cuda":
        raise ValueError(f"pattern_color_kernel runs on cuda, not {dev}")
    for name, x, cols in (("over", over, 3), ("rows", rows, T.SHADE_NCOLS),
                          ("mat_rows", mat_rows, 3)):
        if (x.dtype != torch.float32 or x.device != dev or x.dim() != 2
                or x.shape[0] != r or x.shape[1] < cols
                or (r and x.stride(1) != 1)):
            raise ValueError(
                f"pattern_color_kernel: {name} must be f32 [{r}, >= {cols}] "
                f"on {dev} with unit column stride, not {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    over = over.contiguous()
    tables = []
    for name, dtype in TABLES:
        t = getattr(scene, name)
        if t.dtype != dtype or t.device != dev or t.shape[0] < 1:
            raise ValueError(f"pattern_color_kernel: scene.{name} must be a "
                             f"non-empty {dtype} table on {dev}, not "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        tables.append(t.contiguous())
    out = torch.empty((r, 3), dtype=torch.float32, device=dev)
    if r == 0:
        return out
    n_img, img_h, img_w, _ = scene.images.shape
    err = _library().pattern_color_launch(
        over.data_ptr(), rows.data_ptr(), rows.stride(0), T.SHADE_INV.start,
        T.SHADE_PAT_ID, mat_rows.data_ptr(), mat_rows.stride(0),
        out.data_ptr(), r,
        *[t.data_ptr() for t in tables], scene.pat_kind.shape[0],
        scene.uv_kind.shape[0], n_img, img_h, img_w, INV_2PI, INV_PI,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pattern_color_kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["pattern"] += 1
    return out


# "pattern": the kernel's launches; "pattern_plain": the plain version's
# evaluations (render.base_color_plain), each a level body's
LAUNCHES = dict.fromkeys(("pattern", "pattern_plain"), 0)


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
