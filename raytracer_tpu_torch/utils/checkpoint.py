"""Per-tile checkpoint and resume for long renders.

Counterpart of ``raytracer_tpu/utils/checkpoint.py``. The reference is
one-shot (a crashed 45-minute dragons render restarts from zero). The
pixel-tile grid is restartable: each finished tile is flushed to a .npy
memmap beside a bitmap of finished tiles, so running the same render again
continues from the first missing tile.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from raytracer_tpu_torch.core.render import (
    _order_tiles, camera_consts, full_f32)
from raytracer_tpu_torch.core.tile_program import program_for
from raytracer_tpu_torch.core.types import ARRAY_FIELDS
from raytracer_tpu_torch.utils.profiling import RenderStats


def _render_digest(scene, seed: int) -> str:
    """Digest of everything that decides a tile's contents: every scene
    table's bytes, the static facts (the recursion limit and jitter mode
    included) and the jitter seed. A checkpoint made for another scene or
    seed must not be resumed: it would mix stale tiles into the image."""
    h = hashlib.sha256()
    for name in ARRAY_FIELDS:
        val = getattr(scene, name)
        h.update(name.encode())
        if val is not None:
            a = val.detach().cpu().numpy()
            h.update(str(a.dtype).encode() + str(a.shape).encode())
            h.update(a.tobytes())
    h.update(repr(scene.static).encode())
    h.update(str(int(seed)).encode())
    return h.hexdigest()


def _tile_generator(scene, seed: int, ti: int):
    """Tile ``ti``'s jitter generator, seeded from (seed, ti): the
    counterpart of the JAX package's ``fold_in(key, i)``. None when the
    scene draws no random jitter."""
    st = scene.static
    if not st.area_steps or st.jitter is not None:
        return None
    g = torch.Generator(device=scene.device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), ti])
                      .generate_state(1, np.uint64)[0]))
    return g


def _tile_color(program, scene, idx, generator):
    """One tile's colours [tile, 3] through ``program``, as a numpy
    array."""
    with torch.no_grad():
        return program.to_host(program.run_tile(
            scene, idx, generator, quantize=False)).numpy()


def render_resumable(scene, camera, checkpoint_path, *, seed: int = 0,
                     tile_rays: int = 1 << 14,
                     stats: RenderStats | None = None,
                     max_retries: int = 2, on_retry=None):
    """Like ``core.render.render`` but flushing each tile to disk.

    ``checkpoint_path`` is a directory (``meta.json``, ``image.npy``,
    ``done.npy``); running again with the same path, scene, seed and shape
    resumes after the finished tiles. Returns the float32 image.

    Failure detection: every tile is checked before it is marked done. A
    non-finite tile or a raised error is retried, the same call on the same
    device, up to ``max_retries`` times; a tile that keeps failing raises
    RuntimeError with every other finished tile already flushed, so the
    next run retries only that tile. ``on_retry(tile_index, attempt,
    reason)`` observes the retries.

    Each tile runs through the scene's tile program
    (``core/tile_program.py``: on cuda one CUDA graph launch per tile),
    the counterpart of the JAX package's ``_tile_color_jit``.

    Two differences from the JAX package's ``render_resumable``, each
    leaving the image as ``render`` gives it:

    * Tile order: the tiles are ``render``'s (``_order_tiles``, 16x16
      blocks, so each 256 rays are one K1 subtile), not
      ``_block_order(..., sqrt(tile))`` (the JAX ``_block_order`` docstring
      calls that coupling stale). Each ray's result does not depend on its
      grouping.
    * Jitter: each tile draws its random area-light jitter from its own
      generator, seeded from (``seed``, tile index), in place of the JAX
      package's ``fold_in(key, i)``. A resumed tile draws the jitter of its
      first attempt, so a resumed image equals an uninterrupted one bit for
      bit; a generator shared across tiles would make it depend on which
      tiles were skipped.
    """
    full_f32()
    ckpt = Path(checkpoint_path)
    ckpt.mkdir(parents=True, exist_ok=True)
    meta_p = ckpt / "meta.json"
    img_p = ckpt / "image.npy"
    done_p = ckpt / "done.npy"

    n = camera.vsize * camera.hsize
    tile = min(tile_rays, n)
    n_tiles = -(-n // tile)

    meta = dict(h=camera.vsize, w=camera.hsize, tile=tile,
                digest=_render_digest(scene, seed))
    if meta_p.exists() and json.loads(meta_p.read_text()) == meta \
            and img_p.exists() and done_p.exists():
        flat = np.lib.format.open_memmap(img_p, mode="r+")
        done = np.lib.format.open_memmap(done_p, mode="r+")
    else:
        flat = np.lib.format.open_memmap(
            img_p, mode="w+", dtype=np.float32, shape=(n, 3))
        done = np.lib.format.open_memmap(
            done_p, mode="w+", dtype=bool, shape=(n_tiles,))
        done[:] = False
        meta_p.write_text(json.dumps(meta))

    order, idx_tiles = _order_tiles(camera.vsize, camera.hsize, tile,
                                    scene.device)
    program = program_for(scene, tile, scene.static.recursion_limit)
    program.set_camera(*camera_consts(camera, scene.device), camera.hsize)

    for ti in range(n_tiles):
        if done[ti]:
            continue
        if stats is not None:
            stats.start_tile()
        part = None
        for attempt in range(max_retries + 1):
            try:
                part = _tile_color(program, scene, idx_tiles[ti],
                                   _tile_generator(scene, seed, ti))
            except Exception as e:  # a device or launch error
                reason = f"{type(e).__name__}: {e}"
                part = None
            else:
                if np.isfinite(part).all():
                    break
                reason = "non-finite tile output"
                part = None
            if attempt == max_retries:
                raise RuntimeError(
                    f"tile {ti} failed after {max_retries + 1} attempts "
                    f"({reason}); finished tiles are checkpointed — "
                    f"re-run to retry only this tile"
                )
            if on_retry is not None:
                on_retry(ti, attempt, reason)
        i = ti * tile
        sel = order[i : min(i + tile, n)]
        flat[sel] = part[: len(sel)]
        done[ti] = True
        flat.flush(); done.flush()
        if stats is not None:
            stats.end_tile(len(sel))

    return np.asarray(flat).reshape(camera.vsize, camera.hsize, 3).copy()
