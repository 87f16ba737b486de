"""Nearest / any-hit triangle query over a packed mesh (kernel K1).

Counterpart of ``raytracer_tpu/ops/mesh_pallas.py``:

* K1  :func:`mesh_nearest` — on a CUDA tensor it launches the hand-written
  Hopper kernel ``csrc/mesh_nearest.cu`` (built with nvcc at first use,
  bound through ctypes); on a CPU tensor it takes :func:`mesh_nearest_plain`,
  the same function in plain torch. Nothing else selects the route.
* K1b :func:`live_supergroups` — the per-subtile pre-pass: live
  supergroups of each 256-ray subtile sorted front to back by frustum
  entry distance. A CUDA tensor launches its kernel (same source); a CPU
  tensor takes :func:`live_supergroups_plain`.
* K1c :func:`pack_tri_planes_np` — the packed plane layout
  ``[n_super, SG, N_PLANES*CHUNK]``: each chunk's 10 plane rows are 40 KB
  contiguous, which is what the kernel's bulk copy reads.

Returns per ray (t, tri_index, u, v); misses have t=+inf.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from raytracer_tpu_torch.constants import EPSILON
from raytracer_tpu_torch.ops import gather_cuda as TG

RT = 256           # rays per subtile = threads per CTA (one 16x16 block)
CHUNK = 1024       # triangles per chunk (the unit of the gate)
N_PLANES = 10      # p1.xyz, e1.xyz, e2.xyz, det_eps (per-tri MT threshold)
SG = 8             # chunks per supergroup (the pre-pass granularity)

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "mesh_nearest.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    # the MT arithmetic must round as the plain version does: no FMA
    # contraction, IEEE division/sqrt (nvcc's defaults), no fast math
    "-fmad=false", "-Xptxas", "-v",
)

_lib_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build raytracer_tpu_torch/csrc/mesh_nearest.cu")
    return nvcc


def nvcc_build(source: Path, flags, stem: str) -> tuple[Path, str]:
    """Compile ``source`` with ``flags`` into ``build/lib<stem>-<hash>.so``
    (keyed by the source and the flags) unless already built; returns
    (path, the compiler's log)."""
    src = source.read_bytes()
    key = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"lib{stem}-{key}.so"
    log_path = out.with_suffix(".log")
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.exists() else ""
    return out, log


def build_library() -> tuple[Path, str]:
    """Compile ``csrc/mesh_nearest.cu`` for sm_90a into ``build/`` unless
    already built; returns (path, the compiler's log, with ptxas'
    register and shared-memory report)."""
    return nvcc_build(_CSRC, NVCC_FLAGS, "mesh_nearest")


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.mesh_nearest_launch.argtypes = [
                p, p, p, p, p, p, p, i, p, i, p, p, p, p, p, p, i, i, p]
            lib.mesh_nearest_slices.argtypes = [i]
            lib.mesh_nearest_slices.restype = ctypes.c_int
            lib.live_supergroups_launch.argtypes = [p, p, p, i, p, p, p, p, i,
                                                    p]
            lib.mesh_nearest_launch.restype = ctypes.c_int
            lib.live_supergroups_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def walk_slices(n_rays: int) -> int:
    """Slices per subtile that K1's launcher picks for a call of
    ``n_rays`` rays (it launches n_rays / RT times as many CTAs)."""
    return _library().mesh_nearest_slices(n_rays)


def inverse_dirs(d):
    """1/d with |d| < 1e-12 replaced by 1e-12 (mesh_pallas.py:369)."""
    return 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)


def live_supergroups_plain(origins, inv_d, bb_super, t_cap=None):
    """K1b in torch ops (mesh_pallas ``_live_supergroups``).

    A supergroup is live for a subtile when any of its rays' lines enters
    the supergroup AABB at some t >= 0 and, when ``t_cap`` [R] is given,
    at or before that ray's cap. Live supergroups are ordered front to back
    by their nearest entry distance (a stable sort, as ``jnp.argsort``).

    Returns (ids [n_sub, n_super] i32, cnt [n_sub] i32, ent [n_sub,
    n_super] f32 — the sorted entry distances, +inf past cnt).
    """
    o = origins.reshape(-1, RT, 1, 3)
    inv = inv_d.reshape(-1, RT, 1, 3)
    lo = bb_super[:3].T[None, None]                          # [1,1,ns,3]
    hi = bb_super[3:].T[None, None]
    t0 = (lo - o) * inv                                      # [n_sub,RT,ns,3]
    t1 = (hi - o) * inv
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    hit = (tmin <= tmax + EPSILON) & (tmax >= 0.0)           # [n_sub,RT,ns]
    if t_cap is not None:
        hit &= tmin <= t_cap.reshape(-1, RT, 1)
    live = hit.any(1)                                        # [n_sub,ns]
    entry = torch.where(hit, tmin.clamp_min(0.0), float("inf")).amin(1)
    key = torch.where(live, entry, float("inf"))
    ent, ids = torch.sort(key, dim=1, stable=True)
    cnt = live.sum(1, dtype=torch.int32)
    return ids.to(torch.int32), cnt, ent


PREPASS_SUPER_MAX = 6954   # K1b's keys and boxes in one CTA's shared memory


def live_supergroups(origins, inv_d, bb_super, t_cap=None):
    """K1b: the function of :func:`live_supergroups_plain`, bit for bit.
    A CUDA tensor launches ``live_supergroups_kernel`` (a cluster of 1, 2
    or 4 CTAs per subtile, counted on this wrapper), for at most
    :data:`PREPASS_SUPER_MAX` supergroups; a CPU tensor takes the plain
    version."""
    if origins.device.type == "cpu":
        return live_supergroups_plain(origins, inv_d, bb_super, t_cap)
    r = origins.shape[0]
    n_super = bb_super.shape[1]
    for x in (origins, inv_d, bb_super) + (() if t_cap is None else (t_cap,)):
        if (x.device != origins.device or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError("live_supergroups: want contiguous f32 inputs "
                             f"on {origins.device}")
    if r % RT or tuple(inv_d.shape) != (r, 3) or bb_super.shape[0] != 6:
        raise ValueError("live_supergroups: want [R, 3] rays, R a multiple "
                         f"of {RT}, and bb_super [6, n_super]")
    if n_super > PREPASS_SUPER_MAX:
        raise ValueError(f"live_supergroups: at most {PREPASS_SUPER_MAX} "
                         f"supergroups, not {n_super}")
    dev = origins.device
    n_sub = r // RT
    ids = torch.empty((n_sub, n_super), dtype=torch.int32, device=dev)
    cnt = torch.empty(n_sub, dtype=torch.int32, device=dev)
    ent = torch.empty((n_sub, n_super), dtype=torch.float32, device=dev)
    err = _library().live_supergroups_launch(
        origins.data_ptr(), inv_d.data_ptr(), bb_super.data_ptr(), n_super,
        None if t_cap is None else t_cap.data_ptr(), ids.data_ptr(),
        cnt.data_ptr(), ent.data_ptr(), r,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "live_supergroups")
    live_supergroups.launches += 1
    return ids, cnt, ent


live_supergroups.launches = 0


def _check(o, d, planes, bb, t_init):
    dev = o.device
    r = o.shape[0]
    for name, x, shape in (("origins", o, (r, 3)), ("directions", d, (r, 3))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want f32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if r % RT:
        raise ValueError(f"ray count {r} is not a multiple of {RT}")
    bb_chunk, bb_super = bb
    n_super = planes.shape[0]
    if (planes.dtype != torch.float32
            or tuple(planes.shape) != (n_super, SG, N_PLANES * CHUNK)):
        raise ValueError(f"planes: want f32 [n_super, {SG}, "
                         f"{N_PLANES * CHUNK}], got {tuple(planes.shape)}")
    if tuple(bb_chunk.shape) != (6, n_super * SG) \
            or tuple(bb_super.shape) != (6, n_super):
        raise ValueError("bb: want ([6, n_chunks], [6, n_super]) f32")
    if t_init is not None and (t_init.dtype != torch.float32
                               or tuple(t_init.shape) != (r,)):
        raise ValueError(f"t_init: want f32 [{r}]")
    for x in (o, d, planes, bb_chunk, bb_super) + (
            () if t_init is None else (t_init,)):
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")


def mesh_nearest(origins, directions, planes, bb, *, t_init=None,
                 any_hit=False, reverse=False):
    """Nearest triangle hit per ray (K1).

    origins/directions: [R, 3] f32, R a multiple of RT.
    planes: [n_super, SG, N_PLANES*CHUNK] (pack_tri_planes_np);
    bb: (bb_chunk [6, n_chunks], bb_super [6, n_super]).
    t_init: optional [R] per-ray search cap: hits at t >= t_init report
        +inf; the cap seeds the running best t and culls supergroups.
    any_hit: existence query — any hit strictly below the cap reports
        t=0 (tri_idx/u/v meaningless), +inf otherwise.
    reverse: query the reversed rays (o, -d) — the nearest-behind query of
        ``intersect._tri_behind``.
    Returns (t [R], tri_idx [R] i32, u [R], v [R]).

    A CUDA tensor launches the kernel (and counts the launch); a CPU tensor
    takes the plain version. Build and launch errors propagate.
    """
    _check(origins, directions, planes, bb, t_init)
    if origins.device.type == "cpu":
        return mesh_nearest_plain(origins, directions, planes, bb,
                                  t_init=t_init, any_hit=any_hit,
                                  reverse=reverse)
    if origins.device.type != "cuda":
        raise ValueError(f"mesh_nearest runs on cuda or cpu, not "
                         f"{origins.device}")
    d = -directions if reverse else directions
    r = origins.shape[0]
    dev = origins.device
    if planes.data_ptr() % 16:
        raise ValueError("planes must be 16-byte aligned (bulk copies)")
    inv_d = inverse_dirs(d)
    cap = (torch.full((r,), float("inf"), device=dev) if t_init is None
           else t_init)
    ids, cnt, ent = live_supergroups(origins, inv_d, bb[1], t_init)
    return _walk(origins, d, inv_d, cap, ids, cnt, ent, planes, bb[0],
                 any_hit, "behind" if reverse else (
                     "any_hit" if any_hit else "nearest"))


def _walk(origins, d, inv_d, cap, ids, cnt, ent, planes, bb_chunk, any_hit,
          mode):
    """Launches K1 proper on the pre-pass's lists (counted)."""
    r = origins.shape[0]
    dev = origins.device
    t = torch.empty(r, dtype=torch.float32, device=dev)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    best = torch.empty(r, dtype=torch.int64, device=dev)   # merge words
    err = _library().mesh_nearest_launch(
        origins.data_ptr(), d.data_ptr(), inv_d.data_ptr(), cap.data_ptr(),
        ids.data_ptr(), cnt.data_ptr(), ent.data_ptr(), ids.shape[1],
        bb_chunk.data_ptr(), bb_chunk.shape[1], planes.data_ptr(),
        best.data_ptr(), t.data_ptr(), idx.data_ptr(), u.data_ptr(),
        v.data_ptr(), r, int(bool(any_hit)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "mesh_nearest")
    _wrapper.launches += 1
    _wrapper.launches_by_mode[mode] += 1
    return t, idx, u, v


# the launch counts live on the wrapper; _wrapper stays bound to it even
# when a caller rebinds the module attribute (e.g. to record calls)
_wrapper = mesh_nearest
_wrapper.launches = 0
_wrapper.launches_by_mode = {"nearest": 0, "any_hit": 0, "behind": 0}


def reset_launches():
    """Zeroes the launch counters of K1, K1b and table_gather."""
    _wrapper.launches = 0
    live_supergroups.launches = 0
    for k in _wrapper.launches_by_mode:
        _wrapper.launches_by_mode[k] = 0
    TG.reset_launches()


def launch_counts() -> dict:
    """The launch counters: K1's ("k1" and by mode), K1b's ("prepass")
    and table_gather's, one a kernel ("gather" and "gather_*":
    ops/gather_cuda.launch_counts)."""
    return {"k1": _wrapper.launches, **_wrapper.launches_by_mode,
            "prepass": live_supergroups.launches, **TG.launch_counts()}


def add_launches(delta: dict, sign: int = 1):
    """Adds ``sign`` times ``delta`` (a difference of two
    :func:`launch_counts`) to the counters. A CUDA graph records its
    kernels' launches when it is captured, which launches nothing
    (core/tile_program.py takes them back off) and launches them on every
    replay (it adds them again)."""
    _wrapper.launches += sign * delta["k1"]
    for k in _wrapper.launches_by_mode:
        _wrapper.launches_by_mode[k] += sign * delta[k]
    live_supergroups.launches += sign * delta["prepass"]
    TG.add_launches(delta, sign)


def _cross(a, b):
    """a x b over the last axis of 3, written out."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


class MeshNearest(torch.autograd.Function):
    """K1's nearest query (:func:`mesh_nearest`) with a gradient.

    ``apply(origins, directions, p1, e1, e2, planes, bb, t_init,
    reverse)``: ``p1``/``e1``/``e2`` [Nt, 3] are the free triangles' world
    rows (``Scene.tri_p1[n_csg_tris:]`` ...) that ``planes`` packs; the
    forward reads only the packed planes and boxes, through
    :func:`mesh_nearest` (the kernel on cuda, the plain version on the
    CPU). ``planes``, ``bb``, ``t_init`` and ``reverse`` carry no gradient,
    and neither does ``t_init`` in the JAX package's scan path.

    The backward is a recompute, not a kernel: per ray it gathers the
    winning triangle's rows and differentiates _mt_chunk's t, u and v
    (s = o - p1, p = d x e2, q = s x e1, det = e1.p; u = s.p/det,
    v = d.q/det, t = e2.q/det) by hand. Rays that missed (parked and
    padding rays among them) take det = 1 and a zero cotangent before any
    product, so their gradients are exactly 0 and never 0 * inf. The
    triangle gradients are scattered with ``index_add_``. ``reverse``
    differentiates the query on (o, -d), the nearest-behind query.
    """

    @staticmethod
    def forward(ctx, origins, directions, p1, e1, e2, planes, bb, t_init,
                reverse):
        t, idx, u, v = mesh_nearest(origins, directions, planes, bb,
                                    t_init=t_init, reverse=reverse)
        ctx.save_for_backward(origins, directions, p1, e1, e2, idx,
                              torch.isfinite(t))
        ctx.reverse = reverse
        ctx.mark_non_differentiable(idx)
        return t, idx, u, v

    @staticmethod
    def backward(ctx, g_t, _g_idx, g_u, g_v):
        o, d, p1, e1, e2, idx, hit = ctx.saved_tensors
        if ctx.reverse:
            d = -d
        row = torch.where(hit, idx, 0).long()
        a, b, c = p1[row], e1[row], e2[row]                     # [R, 3]
        zero = torch.zeros_like(g_t)
        g_t, g_u, g_v = (torch.where(hit, g, zero) for g in (g_t, g_u, g_v))

        s = o - a
        p = _cross(d, c)
        q = _cross(s, b)
        inv = 1.0 / torch.where(hit, _dot(b, p), torch.ones_like(g_t))
        # u = (s.p) inv, v = (d.q) inv, t = (e2.q) inv, inv = 1/det
        g_inv = g_u * _dot(s, p) + g_v * _dot(d, q) + g_t * _dot(c, q)
        g_det = -g_inv * inv * inv
        g_s = (g_u * inv)[:, None] * p
        g_p = (g_u * inv)[:, None] * s + g_det[:, None] * b
        g_q = (g_v * inv)[:, None] * d + (g_t * inv)[:, None] * c
        g_d = (g_v * inv)[:, None] * q + _cross(c, g_p)
        g_s = g_s + _cross(b, g_q)
        g_a = -g_s
        g_b = g_det[:, None] * p + _cross(g_q, s)
        g_c = (g_t * inv)[:, None] * q + _cross(g_p, d)
        if ctx.reverse:
            g_d = -g_d

        m = hit[:, None]

        def rows_to(table, g):
            return torch.zeros_like(table).index_add_(
                0, row, torch.where(m, g, 0.0))

        need = ctx.needs_input_grad
        return (torch.where(m, g_s, 0.0) if need[0] else None,
                torch.where(m, g_d, 0.0) if need[1] else None,
                rows_to(p1, g_a) if need[2] else None,
                rows_to(e1, g_b) if need[3] else None,
                rows_to(e2, g_c) if need[4] else None,
                None, None, None, None)


def _mt_chunk(o, d, tri):
    """Moller-Trumbore of rays [n, 3] against one chunk's plane rows
    [N_PLANES, CHUNK], in _mt_merge's order of operations. -> t, u, v
    [n, CHUNK]; failed tests have t=+inf."""
    p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z, det_eps = (
        tri[k][None, :] for k in range(N_PLANES))
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() >= det_eps
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))

    sx = ox - p1x
    sy = oy - p1y
    sz = oz - p1z
    u = (sx * px + sy * py + sz * pz) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)

    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)

    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    t = torch.where(ok & (t > 0.0), t, torch.full_like(t, float("inf")))
    return t, u, v


def mesh_nearest_plain(origins, directions, planes, bb, *, t_init=None,
                       any_hit=False, reverse=False, count_tests=False):
    """The function of :func:`mesh_nearest` in plain torch over the same
    packed tables: chunks in index order, each gated per ray by the same
    slab test against the ray's running best t, Moller-Trumbore in the
    kernel's order of operations, lowest index first on ties, the same cap
    and any-hit semantics. A chunk whose box is empty (min > max on some
    axis: the padding past the mesh's end) is never live.
    ``count_tests=True`` also returns the ray x triangle tests the gates
    let through, counted per ray, per 32-ray warp and per 256-ray block:
    ``{"ray": n, "warp": n, "block": n}`` (a warp or block runs all its
    rays' tests of a chunk once any of them passes)."""
    d = -directions if reverse else directions
    r = origins.shape[0]
    dev = origins.device
    inv_d = inverse_dirs(d)
    cap = (torch.full((r,), float("inf"), device=dev) if t_init is None
           else t_init)
    t = cap.clone()
    g = torch.zeros(r, dtype=torch.int32, device=dev)
    u = torch.zeros(r, dtype=torch.float32, device=dev)
    v = torch.zeros(r, dtype=torch.float32, device=dev)
    bb_chunk = bb[0]
    n_chunks = bb_chunk.shape[1]
    tri = planes.reshape(n_chunks, N_PLANES, CHUNK)
    lo, hi = bb_chunk[:3].T, bb_chunk[3:].T                  # [nc, 3]
    nonempty = (lo <= hi).all(1).tolist()
    tests = {"ray": 0, "warp": 0, "block": 0}
    for c in range(n_chunks):
        if not nonempty[c]:
            continue
        q0 = (lo[c] - origins) * inv_d
        q1 = (hi[c] - origins) * inv_d
        tmin = torch.minimum(q0, q1).amax(-1)
        tmax = torch.maximum(q0, q1).amin(-1)
        live = (tmin <= tmax + EPSILON) & (tmax >= 0.0) & (tmin < t)
        rows = live.nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        if count_tests:
            tests["ray"] += rows.numel() * CHUNK
            for key, w in (("warp", 32), ("block", RT)):
                tests[key] += int(live.reshape(-1, w).any(1).sum()) * w * CHUNK
        ts, us, vs = _mt_chunk(origins[rows], d[rows], tri[c])
        col = ts.argmin(1, keepdim=True)                     # first minimum
        tb = ts.gather(1, col)[:, 0]
        better = tb < t[rows]
        rb = rows[better]
        t[rb] = tb[better]
        g[rb] = (c * CHUNK + col[better, 0]).to(torch.int32)
        u[rb] = us.gather(1, col)[better, 0]
        v[rb] = vs.gather(1, col)[better, 0]
    inf = torch.full_like(t, float("inf"))
    if any_hit:
        t = torch.where(t < cap, torch.zeros_like(t), inf)
    else:
        t = torch.where(t < cap, t, inf)
    out = (t, g, u, v)
    return out + (tests,) if count_tests else out


def pack_tri_planes_np(p1, e1, e2, det_eps=None):
    """K1c: [Nt,3] x3 (+ det_eps [Nt]) -> (planes [n_super, SG,
    N_PLANES*CHUNK], (bb_chunk [6, n_chunks], bb_super [6, n_super])),
    numpy, at scene build.

    Plane k of triangle j of a chunk sits at lane k*CHUNK + j of the
    chunk's row. ``det_eps`` None = plain EPSILON (unit instances).
    Padding triangles are degenerate with threshold +inf (never a hit).
    A chunk of padding only has an empty AABB (min = 3e38 > max = -3e38):
    the slab test alone reads such a box as all of space, so K1's gate
    also tests min <= max on each axis. A supergroup box is the union of
    its chunks' boxes and is empty only if all its chunks are padding,
    which the packing never produces.
    """
    nt = p1.shape[0]
    pad = -nt % (CHUNK * SG)
    n_total = nt + pad
    nc = n_total // CHUNK
    n_super = nc // SG

    def f(x):
        out = np.zeros((n_total, 3), np.float32)
        out[:nt] = x
        return out

    p1p, e1p, e2p = f(p1), f(e1), f(e2)
    de = np.full(n_total, np.inf, np.float32)
    de[:nt] = EPSILON if det_eps is None else det_eps

    tri = np.zeros((n_super, SG, N_PLANES * CHUNK), np.float32)
    for k, x in enumerate((p1p, e1p, e2p)):
        for comp in range(3):
            row = 3 * k + comp
            tri[:, :, row * CHUNK : (row + 1) * CHUNK] = (
                x[:, comp].reshape(n_super, SG, CHUNK)
            )
    tri[:, :, 9 * CHUNK : 10 * CHUNK] = de.reshape(n_super, SG, CHUNK)

    v0 = p1p.reshape(nc, CHUNK, 3)
    v1 = (p1p + e1p).reshape(nc, CHUNK, 3)
    v2 = (p1p + e2p).reshape(nc, CHUNK, 3)
    real = (np.arange(n_total) < nt).reshape(nc, CHUNK, 1)
    big = np.float32(3e38)
    lo = np.where(real, np.minimum(np.minimum(v0, v1), v2), big)
    hi = np.where(real, np.maximum(np.maximum(v0, v1), v2), -big)
    bb_min = lo.min(axis=1)
    bb_max = hi.max(axis=1)
    bb_chunk = np.concatenate([bb_min, bb_max], axis=1).T
    sb_min = bb_min.reshape(n_super, SG, 3).min(axis=1)
    sb_max = bb_max.reshape(n_super, SG, 3).max(axis=1)
    bb_super = np.concatenate([sb_min, sb_max], axis=1).T
    return tri, (
        np.ascontiguousarray(bb_chunk), np.ascontiguousarray(bb_super)
    )
