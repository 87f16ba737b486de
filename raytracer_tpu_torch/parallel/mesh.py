"""Multi-process rendering: the ray axis split over ranks, the scene
replicated.

Counterpart of ``raytracer_tpu/parallel/mesh.py`` over
``torch.distributed``: one process per device, rays split over the ranks in
whole 16x16-pixel blocks (data parallelism; the forward render needs no
collective), every scene table replicated, and the frame assembled with one
``all_gather``. Meshes are ``torch.distributed.device_mesh.DeviceMesh``
objects named ``("rays",)`` or ``("hosts", "rays")``; ``mesh=None`` means
the default process group, or this process alone when none is initialized.

The backend is NCCL for ``cuda`` and gloo for ``cpu``; neither stands in
for the other. Scaling over more than one card has not been measured.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.core.render import (
    _block_order, camera_consts, color_at, full_f32,
    pick_tile_rays, tile_rays as _primary_rays)
from raytracer_tpu_torch.core.tile_program import program_for
from raytracer_tpu_torch.ops.mesh_cuda import RT

RAY_AXIS = "rays"
HOST_AXIS = "hosts"
_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_distributed(init_method=None, world_size=None, rank=None, *,
                     device="cuda"):
    """Initialize the default process group once per process, before any
    collective. With ``init_method`` (e.g. ``"tcp://localhost:29500"``),
    ``world_size`` and ``rank``, or with torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); otherwise,
    and when a group exists already, it does nothing. The backend is
    ``nccl`` for a ``cuda`` device (each rank takes card ``LOCAL_RANK``,
    default its rank) and ``gloo`` for ``cpu``. Returns (rank,
    world_size)."""
    if not dist.is_initialized() and (
            init_method is not None or all(k in os.environ for k in _ENV)):
        device = torch.device(device)
        if device.type == "cuda":
            backend = "nccl"
            local = int(os.environ.get("LOCAL_RANK", rank or 0))
            torch.cuda.set_device(local)
        elif device.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"no process-group backend for {device}")
        given = dict(world_size=world_size, rank=rank)
        dist.init_process_group(backend, init_method=init_method, **{
            k: v for k, v in given.items() if v is not None})
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def make_mesh(device_type: str = "cuda", axis: str = RAY_AXIS):
    """1-D mesh over every rank of the default group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def make_host_mesh(device_type: str = "cuda", axis_host: str = HOST_AXIS,
                   axis_chip: str = RAY_AXIS):
    """2-D (hosts, ranks per host) mesh over every rank, rows being hosts
    (ranks are numbered host-major, as torchrun numbers them); the ranks
    per host are torchrun's ``LOCAL_WORLD_SIZE`` (without it, every rank on
    one host). Rays split over both axes; gradients reduce over the ranks
    of a host first, then across hosts
    (:func:`~raytracer_tpu_torch.parallel.train.make_sharded_train_step`)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local_size:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{local_size}")
    return init_device_mesh(device_type, (world // local_size, local_size),
                            mesh_dim_names=(axis_host, axis_chip))


def _layout(mesh):
    """(this rank's position among the mesh's ranks in row-major order,
    their count, the process groups of the mesh's dimensions, outermost
    first)."""
    if mesh is None:
        if not dist.is_initialized():
            return 0, 1, []
        return dist.get_rank(), dist.get_world_size(), [dist.group.WORLD]
    coord = mesh.get_coordinate()
    pos = int(np.ravel_multi_index(coord, mesh.shape))
    return pos, mesh.size(), [mesh.get_group(i) for i in range(mesh.ndim)]


def _all_gather(x, groups):
    """``x`` of every rank, stacked in the mesh's row-major rank order
    [n_ranks, *x.shape]: gathered over the innermost dimension first, then
    outwards."""
    x = x.contiguous()
    shape = x.shape
    for g in reversed(groups):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, x, group=g)
        x = torch.stack(parts)
    return x.reshape(-1, *shape)


def replicate_scene(scene: T.Scene) -> T.Scene:
    """Rank 0's scene on every rank of the default group (which every mesh
    of this module spans): its static facts and table shapes go out first,
    then each table is broadcast into a buffer on this rank's device, so
    every rank renders the same scene even where their builds differ. No
    process group: ``scene`` itself.

    The replica is kept on ``scene``: when every rank passes the scene it
    passed last time (one ``all_reduce`` of a flag decides), each gets its
    kept replica back, and with it the replica's tile program, so a second
    ``render_sharded`` of one scene replays the graphs of the first."""
    if not dist.is_initialized():
        return scene
    kept = scene.__dict__.get("_replica")
    have = torch.tensor([int(kept is not None)], device=scene.device)
    dist.all_reduce(have, op=dist.ReduceOp.MIN)
    if int(have) == 1:
        return kept
    scene.__dict__["_replica"] = replica = _broadcast_scene(scene)
    return replica


def _broadcast_scene(scene: T.Scene) -> T.Scene:
    """Rank 0's static facts and tables, broadcast to every rank."""
    rank = dist.get_rank()
    meta = [(scene.static, {
        k: None if getattr(scene, k) is None
        else (tuple(getattr(scene, k).shape), getattr(scene, k).dtype)
        for k in T.ARRAY_FIELDS})]
    dist.broadcast_object_list(meta, src=0)
    static, shapes = meta[0]
    dev = scene.device
    tables = {}
    for k in T.ARRAY_FIELDS:
        if shapes[k] is None:
            tables[k] = None
            continue
        shape, dtype = shapes[k]
        # the source of a broadcast is only read: rank 0 sends its table
        buf = (getattr(scene, k).detach().contiguous() if rank == 0
               else torch.empty(shape, dtype=dtype, device=dev))
        # gloo moves no bool tensors: send their bytes
        wire = buf.view(torch.uint8) if dtype == torch.bool else buf
        dist.broadcast(wire, src=0)
        tables[k] = buf
    return T.Scene(**tables, static=static)


def shard_rays(origins, directions, mesh=None):
    """This rank's slab of a ray batch: padded to a multiple of the rank
    count (origins 0, directions (0, 0, 1), so every ray stays finite) and
    split in equal contiguous slabs. Returns (origins, directions, n), n
    the batch size before padding."""
    pos, n_ranks, _ = _layout(mesh)
    n = origins.shape[0]
    pad = -n % n_ranks
    if pad:
        origins = torch.cat([origins, origins.new_zeros((pad, 3))])
        directions = torch.cat([directions, directions.new_tensor(
            [0.0, 0.0, 1.0]).expand(pad, 3)])
    m = origins.shape[0] // n_ranks
    sl = slice(pos * m, (pos + 1) * m)
    return origins[sl], directions[sl], n


def render_sharded(scene: T.Scene, camera, mesh=None, *, tile_rays=None,
                   generator=None, graphs=True):
    """Full frame, the rays split over the ranks of ``mesh``; every rank
    returns the same float32 [vsize, hsize, 3] numpy image.

    The frame is ``render``'s 16x16-block order cut in tiles of
    ``tile_rays`` rays (default: ``render``'s tile on every rank), and each
    tile's pixel ids are split over the ranks in equal slabs of whole
    256-ray blocks, so every rank gets screen-local K1 subtiles. Each rank
    makes its own rays on its own device (``tile_rays``' camera math from
    the pixel ids) and renders its slabs; one ``all_gather`` assembles the
    frame on every rank (the JAX package's ``multihost`` contract).

    ``generator``: this rank's area-light jitter (None: seeded with the
    rank's position, so one process alone draws as ``render`` does);
    seeded frames agree with ``render``'s in distribution.

    ``graphs=True`` runs each rank's slabs through the replica's tile
    program (``core/tile_program.program_for(scene, per_rank, limit)``,
    the JAX package's jitted ``run``): on cuda one CUDA graph launch per
    tile, its level skip and widths taken on the card, on the CPU the
    same steps without capture.
    ``graphs=False`` runs :func:`~raytracer_tpu_torch.core.render.color_at`
    slab by slab. Both give the same frame bit for bit."""
    full_f32()
    pos, n_ranks, groups = _layout(mesh)
    scene = replicate_scene(scene)
    device = scene.device
    st = scene.static
    n = camera.vsize * camera.hsize
    if tile_rays is None:
        tile_rays = pick_tile_rays(st) * n_ranks
    per_rank = max(RT, tile_rays // n_ranks // RT * RT)
    per_rank = min(per_rank, -(-n // (n_ranks * RT)) * RT)
    tile = per_rank * n_ranks
    order = _block_order(camera.vsize, camera.hsize, 16)
    padded = np.pad(order, (0, -n % tile))
    slabs = torch.as_tensor(padded.reshape(-1, n_ranks, per_rank)[:, pos],
                            device=device)
    if st.area_steps and st.jitter is None and generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(pos)
    inv, consts = camera_consts(camera, device)
    with torch.no_grad():
        if graphs:
            prog = program_for(scene, per_rank, st.recursion_limit)
            prog.set_camera(inv, consts, camera.hsize)
            mine = prog.frame(scene, slabs, False, generator)
        else:
            mine = torch.cat([
                color_at(scene, *_primary_rays(inv, consts, idx,
                                               camera.hsize),
                         st.recursion_limit, generator) for idx in slabs])
        if groups:          # one rank in a group still takes the collective
            every = _all_gather(mine.reshape(len(slabs), per_rank, 3), groups)
            mine = every.transpose(0, 1)        # [tile, rank, per_rank, 3]
        mine = mine.reshape(-1, 3)[:n]
        img = (prog.to_host(mine) if graphs else mine.cpu()).numpy()
    out = np.empty_like(img)
    out[order] = img
    return out.reshape(camera.vsize, camera.hsize, 3)

