"""The wavefront integrator: whole-tile ray batches, unrolled bounce tree.

Counterpart of ``raytracer_tpu/core/render.py``. The reference's recursive
per-pixel color_at (world.rs:91-148) becomes a level-by-level loop: level L
holds every ray spawned at bounce depth L, each level is one batched trace
+ shade, and contributions are pre-weighted by the product of
reflective/transparency/Schlick factors along the path — linearity makes
this exactly the recursive sum. Static scene flags prune branches whose
weight is identically zero.

Reference semantics preserved deliberately:
  * shade_hit adds reflected+refracted PER LIGHT (world.rs:64-89), so child
    weights are multiplied by the light count (area lights included);
  * is_shadowed tests only the nearest positive hit's shadow flag
    (world.rs:101-111);
  * area lights draw fresh jitter for the intensity pass and the lighting
    pass (lights.rs:105-134, materials.rs:136-175); the deterministic
    sequence mode (``SceneStatic.jitter``) replaces the random draws like
    the reference's test hook (lights.rs:77-81) and gives the JAX
    package's values exactly.

Random jitter. Without a deterministic sequence, every area light of every
level of every tile draws ``torch.rand((R, S, 4))`` from ONE
``torch.Generator`` on the scene's device: tiles in order, within a tile
the levels in order (a level that does not run draws nothing), within a
level the area lights in order. ``render`` and ``color_at`` take
``generator=None``, which means a generator seeded with 0 (the JAX
package's default is ``PRNGKey(0)``). The stream is not JAX's threefry,
and torch's CPU and CUDA generators give different streams for one seed,
so seeded frames agree with the JAX package (and across devices) in
distribution, not pixel for pixel.

Live-ray compaction. Deep levels of mesh and area-light scenes are mostly
parked rays, so ``color_at`` sorts a level's live rays to the front and
shades only the narrowest of R/16, R/4, R/2 or R rows that holds them
(:func:`_packed_shade_level`, the JAX package's rule and widths). The width
is a host decision, read in the same sync as the whole-level skip; the JAX
package's ``lax.cond`` chain takes that place there.

Not ported: the JAX package's ``_max_mesh_tile`` clamp, which sizes tiles
to the TPU's 1 MB of scalar memory; K1's pre-pass tables live in global
memory and its launcher sizes the grid from the ray count.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from raytracer_tpu_torch.constants import EPSILON
from raytracer_tpu_torch.core import intersect as I
from raytracer_tpu_torch.core import shading as SH
from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.core.patterns import pattern_color


def shadowed(scene: T.Scene, points, light_pos):
    """world.rs:101-111: nearest positive hit closer than the light and
    casting shadows."""
    pos = torch.as_tensor(light_pos, dtype=points.dtype,
                          device=points.device).expand(points.shape)[:, None]
    return I.shadow_blocked(scene, points, pos)[:, 0]


def scene_mat_col(mat_rows, col):
    return mat_rows[:, col : col + 1]


# Parked-ray sentinel: a ray at x=y=3e8 pointing +z has an empty slab
# interval against every scene AABB, which kills the mesh kernel's
# supergroup and chunk gates. Zero-weight and missed rays are parked.
PARK_ORIGIN = (3e8, 3e8, 3e8)
PARK_DIR = (0.0, 0.0, 1.0)


def park_rays(o, d, active):
    po = torch.tensor(PARK_ORIGIN, dtype=o.dtype, device=o.device)
    pd = torch.tensor(PARK_DIR, dtype=d.dtype, device=d.device)
    return (
        torch.where(active[:, None], o, po),
        torch.where(active[:, None], d, pd),
    )


def _det_jitter_tables(static: T.SceneStatic, s_total, phase=0):
    """Deterministic jitter constants per sample (lights.rs:77-121 test
    hook), the JAX package's tables exactly.

    The reference cycles ONE sequence shared by every area light: per
    shading point, ``intensity_at`` consumes 2 draws per sample in u-major
    order (u jitter then v jitter), then ``lighting``'s area branch
    consumes 2 more per sample in the same order (materials.rs:139-142).
    The shading point starts at cycle ``phase``; the caller advances it by
    ``4 * samples`` per preceding area light (world.rs:66-76). Each shading
    point starts at phase 0 (the reference's per-pixel phase depends on
    its thread schedule).
    """
    seq = static.jitter
    n = len(seq)

    def tab(off):
        return np.array(
            [seq[(phase + off + 2 * c) % n] for c in range(s_total)],
            np.float32)

    return tab(0), tab(1), tab(2 * s_total), tab(2 * s_total + 1)


def _area_light_contrib(scene, ai, over, eyev, normalv, base_color, mat_rows,
                        generator, live=None, jitter_phase=0):
    """Shadow fraction + sampled Phong for area light ``ai``, all in
    [R, S] form: one shadow query of R x S rays through
    intersect.shadow_blocked (the mesh kernel sees one call of R*S rays),
    and Phong broadcasting [R, 1, ...] rows against [R, S, 3] samples."""
    st = scene.static
    us, vs = st.area_steps[ai]
    s_total = us * vs
    corner = scene.alight_corner[ai]
    uvec = scene.alight_uvec[ai]
    vvec = scene.alight_vvec[ai]
    intensity = scene.alight_intensity[ai]
    r = over.shape[0]
    dev = over.device

    uu = torch.as_tensor(np.repeat(np.arange(us, dtype=np.float32), vs),
                         device=dev)                                  # [S]
    vv = torch.as_tensor(np.tile(np.arange(vs, dtype=np.float32), us),
                         device=dev)
    if st.jitter is not None:
        ju1, jv1, ju2, jv2 = (
            torch.as_tensor(x, device=dev)[None, :]
            for x in _det_jitter_tables(st, s_total, jitter_phase)
        )                                                             # [1, S]
    else:
        jj = torch.rand((r, s_total, 4), generator=generator, device=dev)
        ju1, jv1, ju2, jv2 = jj[..., 0], jj[..., 1], jj[..., 2], jj[..., 3]

    def positions(ju, jv):
        return (corner + (uu[None, :] + ju)[..., None] * uvec
                + (vv[None, :] + jv)[..., None] * vvec)              # [R|1,S,3]

    sh = I.shadow_blocked(scene, over, positions(ju1, jv1), live=live)
    int_sum = (1.0 - sh.to(torch.float32)).sum(-1)                   # [R]

    ds = SH.phong(
        mat_rows[:, None], base_color[:, None], intensity[None, None],
        positions(ju2, jv2), over[:, None], eyev[:, None], normalv[:, None],
    ).sum(1)                                                          # [R, 3]

    eff = base_color * intensity[None]
    ambient = eff * scene_mat_col(mat_rows, T.MAT_AMBIENT)
    frac = int_sum / s_total
    return ambient + (ds / s_total) * frac[:, None]


def _seeded(generator, device):
    """``generator``, or a new one on ``device`` seeded with 0."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


def shade_level(scene: T.Scene, o, d, weight, generator=None):
    """Trace + shade one wavefront level. ``generator`` draws the random
    area-light jitter (see the module docstring); it may be None when the
    scene has no area light or a deterministic jitter sequence.

    Returns (weighted surface color [R,3], reflect spawn, refract spawn),
    each spawn = (origin, direction, child_weight).
    """
    st = scene.static
    if st.has_transparency and not st.all_ri_one:
        # the n1/n2 container walk needs the whole candidate table
        ts, gids, us, vs = I.candidate_hits(scene, o, d)
        has, t, gid, u, v, slot = I.first_hit(ts, gids, us, vs)
    else:
        # all_ri_one: the walk could only return (1, 1), so the nearest
        # hit suffices and the refraction math gets the constants
        has, t, gid, u, v = I.nearest_hit(scene, o, d)
        ts = gids = slot = None
    gid = torch.where(has, gid, 0).long()
    t = torch.where(has, t, 1.0)

    point = o + t[:, None] * d
    eyev = -d
    # one tri->source row lookup shared by every per-primitive attribute
    tgid = I.transform_row(scene, gid)
    inv_rows = scene.inv_tf[tgid]
    nmat_rows = scene.normal_mat[tgid]
    mat_idx = scene.mat_id[tgid].long()
    pat_id = scene.pattern_id[tgid]

    normalv = SH.normal_at(
        scene, gid, point, u, v, tgid=tgid, inv=inv_rows, nmat=nmat_rows
    )
    flip = I.dot3(normalv, eyev) < 0.0
    normalv = torch.where(flip[:, None], -normalv, normalv)
    over = point + EPSILON * normalv
    under = point - EPSILON * normalv
    # missed rays trace no shadows: park their shading point so the mesh
    # gates reject it (their surface term is masked to 0 below anyway)
    over_sh, _ = park_rays(over, d, has)

    mat_rows = scene.mat[mat_idx]
    pat = pattern_color(scene, gid, over, pid=pat_id, inv=inv_rows)
    has_pat = pat_id >= 0
    base_color = torch.where(has_pat[:, None], pat, mat_rows[:, T.MAT_COLOR])

    surface = torch.zeros_like(base_color)
    n_point = scene.plight_pos.shape[0]
    for li in range(n_point):
        lpos = scene.plight_pos[li]
        lint = scene.plight_intensity[li]
        blocked = I.shadow_blocked(
            scene, over_sh, lpos.expand(over_sh.shape[0], 1, 3), live=has,
        )[:, 0]
        inten = torch.where(blocked, 0.0, 1.0)
        eff = base_color * lint[None]
        ambient = eff * scene_mat_col(mat_rows, T.MAT_AMBIENT)
        ds = SH.phong(mat_rows, base_color, lint[None], lpos[None], over,
                      eyev, normalv)
        surface = surface + ambient + ds * inten[:, None]

    jitter_phase = 0  # the shared cycle advances 4*S per area light
    for ai, (us, vs) in enumerate(st.area_steps):
        surface = surface + _area_light_contrib(
            scene, ai, over_sh, eyev, normalv, base_color, mat_rows,
            generator, live=has, jitter_phase=jitter_phase,
        )
        jitter_phase += 4 * us * vs

    surface = torch.where(has[:, None], surface, 0.0)

    # --- secondary rays ---------------------------------------------------
    if st.has_transparency and not st.all_ri_one:
        n1, n2 = SH.refraction_indices_fast(scene, ts, gids, slot)
    else:
        n1 = n2 = torch.ones_like(t)

    reflective = mat_rows[:, T.MAT_REFLECTIVE]
    transparency = mat_rows[:, T.MAT_TRANSPARENCY]
    blend = (reflective > 0.0) & (transparency > 0.0)
    r_schlick = SH.schlick(eyev, normalv, n1, n2)
    refl_factor = torch.where(blend, r_schlick, 1.0)
    refr_factor = torch.where(blend, 1.0 - r_schlick, 1.0)

    n_lights = float(n_point + len(st.area_steps))
    reflectv = SH.reflect(d, normalv)
    w_reflect = weight * torch.where(
        has, reflective * refl_factor * n_lights, 0.0
    )[:, None]

    n_ratio = n1 / n2
    cos_i = I.dot3(eyev, normalv)
    sin2_t = n_ratio * n_ratio * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-10))
    refr_dir = ((n_ratio * cos_i - cos_t)[:, None] * normalv
                - n_ratio[:, None] * eyev)
    # Snell's construction does not preserve length; downstream shading
    # assumes unit directions
    refr_dir = refr_dir / torch.clamp_min(
        torch.sqrt(I.dot3(refr_dir, refr_dir)), 1e-12)[:, None]
    w_refract = weight * torch.where(
        has & ~tir, transparency * refr_factor * n_lights, 0.0
    )[:, None]

    return (
        weight * surface,
        (over, reflectv, w_reflect),
        (under, refr_dir, w_refract),
    )


def _packed_width(r: int, n_live: int) -> int:
    """The narrowest of R/16, R/4, R/2 and R that holds ``n_live`` rays
    (the JAX package's cond chain, ``render.py:338-348``)."""
    for width in (r // 16, r // 4, r // 2):
        if n_live <= width:
            return width
    return r


def _packed_shade_level(scene: T.Scene, o, d, w, generator=None, *,
                        thread_perm=False, width):
    """:func:`shade_level` with the live rays (any weight > 0) moved to the
    front in a stable order and shaded at ``width`` rows, the narrowest of
    R/16, R/4, R/2 and R that holds them (:func:`_packed_width` of the live
    count, which the caller has read). The rows past the live rays are
    parked padding. Each ray's result does not depend on its batch or its
    neighbours (K1's gates are conservative), so this is exact; the
    area-light jitter is drawn at ``(width, S, 4)``, so a seeded frame
    agrees with the full-width one in distribution.

    Returns shade_level's outputs at R rows, in the rays' own order; with
    ``thread_perm``, in the sorted order instead, plus the permutation
    ``order`` (slot -> row), which the caller composes across levels and
    undoes once (``color_at``)."""
    r = o.shape[0]
    live = (w > 0.0).any(-1)
    order = torch.argsort((~live).to(torch.uint8), stable=True)
    sel = order[:width]
    colored, refl, refr = shade_level(scene, o[sel], d[sel], w[sel],
                                      generator)
    out = [colored]
    for spawn in (refl, refr):
        out += list(spawn)
    if width < r:
        zero = torch.zeros(3, dtype=colored.dtype, device=o.device)
        po = torch.tensor(PARK_ORIGIN, dtype=o.dtype, device=o.device)
        pd = torch.tensor(PARK_DIR, dtype=d.dtype, device=d.device)
        fills = (zero, po, pd, zero, po, pd, zero)
        out = [torch.cat([x, f.expand(r - width, 3)]) for x, f in
               zip(out, fills)]
    if not thread_perm:
        inv_order = torch.argsort(order)
        out = [x[inv_order] for x in out]
    res = out[0], tuple(out[1:4]), tuple(out[4:7])
    return res + (order,) if thread_perm else res


def _remat(level_fn, scene, o, d, w, generator):
    """``level_fn(scene, o, d, w, generator)`` under
    ``torch.utils.checkpoint``: the backward pass recomputes the level
    instead of keeping its intermediates.

    Checkpoint replays the default RNG streams, not an explicit
    ``torch.Generator``. So the level draws its jitter from a private
    generator started from a snapshot of ``generator``; the recompute
    starts from the same snapshot and draws the same jitter, and
    ``generator`` moves on once, to where the first run left it."""
    if generator is None:
        return checkpoint(level_fn, scene, o, d, w, None,
                          use_reentrant=False)
    start = generator.get_state()
    end = []

    def level(o, d, w):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        out = level_fn(scene, o, d, w, g)
        if not end:
            end.append(g.get_state())
        return out

    out = checkpoint(level, o, d, w, use_reentrant=False)
    generator.set_state(end[0])
    return out


def packs(static: T.SceneStatic, r: int) -> bool:
    """Whether ``color_at`` compacts a level of ``r`` rays (the JAX
    package's rule, ``render.py:406-410``): mesh scenes of over 20,000
    free triangles and area-light scenes, at R >= 4096 and R % 16 == 0.
    Scenes of small primitives keep their levels mostly live, and there a
    sort costs more than it saves."""
    return bool((static.counts[5] - static.n_csg_tris > 20000
                 or static.area_steps) and r >= 4096 and r % 16 == 0)


def color_at(scene: T.Scene, origins, directions, limit=None,
             generator=None, *, remat=False):
    """world.rs:91-99 over a ray batch, bounce tree unrolled level by
    level. Once every ray of a level has zero weight, that level and every
    later one contribute nothing, so the loop stops there. ``generator``:
    the area-light jitter's (None: seed 0; see the module docstring).

    Levels after the first are compacted where :func:`packs` says so
    (:func:`_packed_shade_level`): the live count, read once per level for
    the skip, picks the width. Without a blend material the level width
    stays R, so the packed levels keep their outputs in sorted order, the
    image follows, and the composed permutation is undone once at the end
    (``thread_perm``); blend scenes, whose levels double by concatenation,
    un-permute each level.

    ``remat=True`` runs every level under ``torch.utils.checkpoint``
    (:func:`_remat`): the backward pass recomputes each level's trace, K1
    included, instead of storing its intermediates, so only the level
    inputs (o, d, w) live across it. A blend scene's deepest level is 16R
    wide at depth 4. The forward values are the same either way."""
    st = scene.static
    if st.area_steps and st.jitter is None:
        generator = _seeded(generator, origins.device)
    if limit is None:
        limit = st.recursion_limit
    r = origins.shape[0]
    img = torch.zeros((r, 3), device=origins.device)

    o, d = origins, directions
    w = torch.ones((r, 3), device=origins.device)
    # composed live-first permutation (slot -> original row) of the packed
    # levels that keep their outputs sorted; img follows the slot order
    perm = None
    thread_perm = not st.has_blend
    for level in range(limit + 1):
        level_fn = shade_level
        if level > 0:
            n_live = int((w > 0.0).any(-1).sum())   # the level's one sync
            if n_live == 0:
                break
            if packs(st, o.shape[0]):
                level_fn = functools.partial(
                    _packed_shade_level, thread_perm=thread_perm,
                    width=_packed_width(o.shape[0], n_live))
        if remat:
            colored, refl, refr, *order = _remat(level_fn, scene, o, d, w,
                                                 generator)
        else:
            colored, refl, refr, *order = level_fn(scene, o, d, w, generator)
        if order:
            perm = order[0] if perm is None else perm[order[0]]
            # the spawn merge below takes refl/refr in this order too
            img = img[order[0]] + colored
        else:
            img = img + colored.reshape(-1, r, 3).sum(0)
        if level == limit:
            break
        spawns = []
        if st.has_reflective:
            spawns.append(refl)
        if st.has_transparency:
            spawns.append(refr)
        if not spawns:
            break
        if len(spawns) == 2 and not st.has_blend:
            # No material is both reflective and transparent: the two
            # spawn weights are disjoint per ray, so select instead of
            # concatenate and the level width stays R (exact).
            (ro, rd, rw), (fo, fd, fw) = spawns
            take_r = (rw > 0.0).any(-1, keepdim=True)
            o = torch.where(take_r, ro, fo)
            d = torch.where(take_r, rd, fd)
            w = rw + fw
        else:
            o = torch.cat([s[0] for s in spawns], 0)
            d = torch.cat([s[1] for s in spawns], 0)
            w = torch.cat([s[2] for s in spawns], 0)
        # park zero-weight spawns: they cost the mesh kernel nothing
        o, d = park_rays(o, d, (w > 0.0).any(-1))
    if perm is not None:
        img = img[torch.argsort(perm)]      # undo the composed permutation
    return img


def tile_rays(inv, consts, idx, hsize: int):
    """Primary rays for flat pixel ids, on the device (camera.rs:45-64).

    inv: [4,4] inverse camera transform; consts: [3] = (half_width,
    half_height, pixel_size); idx: [R] flat pixel ids (py*hsize+px).
    Returns (origins [R,3], directions [R,3]).
    """
    half_w, half_h, psize = consts[0], consts[1], consts[2]
    origin = inv[:3, 3]
    pxf = (idx % hsize).to(torch.float32)
    pyf = (idx // hsize).to(torch.float32)
    wx = half_w - (pxf + 0.5) * psize
    wy = half_h - (pyf + 0.5) * psize
    # inv @ (wx, wy, -1, 1), written out (rows 0..2 only)
    pw = (wx[:, None] * inv[:3, 0] + wy[:, None] * inv[:3, 1]
          - inv[:3, 2] + inv[:3, 3])
    d = pw - origin
    d = d / torch.sqrt(I.dot3(d, d))[:, None]
    return origin.expand(d.shape).contiguous(), d


_primary_rays = tile_rays  # render()'s keyword of the same name shadows it


def camera_consts(camera, device):
    """(inv [4,4], consts [3]) device args of :func:`tile_rays`."""
    inv = torch.as_tensor(
        np.linalg.inv(camera.transform).astype(np.float32), device=device)
    consts = torch.tensor(
        [camera.half_width, camera.half_height, camera.pixel_size],
        dtype=torch.float32, device=device,
    )
    return inv, consts


def _block_order(h, w, block):
    """Flat pixel indices in square-block-major order. Each consecutive
    256 ids form one 16x16 pixel square: one CTA of the mesh kernel, whose
    chunk gates then see a tight ray frustum."""
    block = max(min(block, h, w), 1)
    cols = []
    for y0 in range(0, h, block):
        for x0 in range(0, w, block):
            ys = np.arange(y0, min(y0 + block, h))
            xs = np.arange(x0, min(x0 + block, w))
            cols.append((ys[:, None] * w + xs[None, :]).ravel())
    return np.concatenate(cols)


def _order_tiles(h, w, tile, device):
    """(host order [n], idx_tiles [n_tiles, tile] on device); padding
    repeats pixel 0."""
    order = _block_order(h, w, 16)     # 16x16 = one 256-ray subtile
    n_pad = -(h * w) % tile
    padded = np.pad(order, (0, n_pad)) if n_pad else order
    idx_tiles = torch.as_tensor(padded.reshape(-1, tile), device=device)
    return order, idx_tiles


def pick_tile_rays(static: T.SceneStatic) -> int:
    """Rays per tile (each tile is one color_at batch). The structure of
    the JAX package's choice; the constants are unswept on the H100.
    Area-light scenes take smaller tiles: their shadow and Phong math
    holds [R, S, ...] sample tables (S = 100 for a 10x10 light), and a CSG
    tree filters R x S rows of [C, C] pairs."""
    n_free_tris = static.counts[5] - static.n_csg_tris
    if static.area_steps:
        return 1 << 12 if static.csg_nodes else 1 << 14
    if static.has_blend:
        # blend spawn concatenation grows deep levels to 2^depth R
        return 1 << 14
    return 1 << 14 if n_free_tris > 20000 else 1 << 17


def full_f32():
    """Hold matmuls and convolutions to full f32 on the card: TF32 would
    round the hit geometry the way the TPU's bf16 matrix pass did. Every
    entry point that runs the trace calls it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def render(scene: T.Scene, camera, *, tile_rays=None, quantize=False,
           generator=None):
    """Full frame -> float32 [vsize, hsize, 3] numpy image, on the scene's
    device (``build_scene`` puts it on ``cuda`` unless told otherwise).

    ``quantize=True`` returns uint8 instead, quantized on the device with
    the formula of :func:`canvas.quantize_u8`, floor(clip(x,0,1)*255+0.5).
    ``generator``: a ``torch.Generator`` on the scene's device for the
    area-light jitter, which the tiles draw from in turn (None: seed 0;
    see the module docstring).

    Matmuls and convolutions are held to full f32 (:func:`full_f32`).
    """
    full_f32()
    device = scene.device
    if tile_rays is None:
        tile_rays = pick_tile_rays(scene.static)
    n = camera.vsize * camera.hsize
    tile = min(tile_rays, n)
    order, idx_tiles = _order_tiles(camera.vsize, camera.hsize, tile, device)
    inv, consts = camera_consts(camera, device)
    limit = scene.static.recursion_limit
    if scene.static.area_steps and scene.static.jitter is None:
        generator = _seeded(generator, device)
    outs = []
    with torch.no_grad():
        for idx in idx_tiles:
            o, d = _primary_rays(inv, consts, idx, camera.hsize)
            c = color_at(scene, o, d, limit, generator)
            if quantize:
                c = torch.floor(c.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
            outs.append(c)
        img = torch.cat(outs).cpu().numpy()[:n]
    out = np.empty_like(img)
    out[order] = img
    return out.reshape(camera.vsize, camera.hsize, 3)
