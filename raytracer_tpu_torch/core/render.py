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
every level from 0 to the last (:func:`level_rows`) in order, at the
level's whole width R whether the level runs or not, within a level the
area lights in order (:func:`draw_jitter`). A packed level shades the
first ``width`` rows of its draws. The rule does not depend on which
levels run or at what width, so the tile program, whose graph takes
those decisions on the card, draws a tile's jitter before it runs.
``render`` and ``color_at`` take ``generator=None``, which means a
generator seeded with 0 (the JAX
package's default is ``PRNGKey(0)``). The stream is not JAX's threefry,
and torch's CPU and CUDA generators give different streams for one seed,
so seeded frames agree with the JAX package (and across devices) in
distribution, not pixel for pixel.

Live-ray compaction. Deep levels of mesh and area-light scenes are mostly
parked rays, so ``color_at`` shades only a level's live rays, at the
narrowest of R/16, R/4, R/2 or R rows that holds them (the JAX package's
rule and widths): they are found by a prefix sum, gathered once, shaded
and copied back into their rows (:func:`_packed_shade_level`); a level at
width R runs whole. The levels of a blend scene, which double by
concatenation, are mostly parked too; they pack wherever the level keeps
nothing for a backward (:func:`packs`), a rule of the port's own. In
:func:`color_at` the width is a host decision, read in the same sync as
the whole-level skip.

The compiled frame. ``render`` runs each tile through
``core/tile_program.TileProgram``, the counterpart of the JAX package's
``_tile_color_jit``/``_render_frame_jit``: the level steps below
(:func:`level_step`, :func:`dead_step`) in one CUDA graph per tile, in
which the level skip and the packed width are taken on the card by
``level_control_kernel`` and conditional nodes (``ops/graph_cuda``), the
counterpart of the JAX package's ``lax.cond`` chain.
``render(..., graphs=False)`` and :func:`color_at` run the same steps
eagerly.

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
from raytracer_tpu_torch.ops import patterns_cuda as PC
from raytracer_tpu_torch.utils import profiling as P


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
    po = T.small_const(PARK_ORIGIN, o.device, o.dtype)
    pd = T.small_const(PARK_DIR, d.device, d.dtype)
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


def _area_tables(scene, ai, phase):
    """(uu [S], vv [S], the deterministic jitter tables [1, S] x 4 or
    None) of area light ``ai``, made once per scene."""
    st = scene.static

    def build():
        us, vs = st.area_steps[ai]
        dev = scene.device
        uu = torch.as_tensor(np.repeat(np.arange(us, dtype=np.float32), vs),
                             device=dev)
        vv = torch.as_tensor(np.tile(np.arange(vs, dtype=np.float32), us),
                             device=dev)
        det = None if st.jitter is None else tuple(
            torch.as_tensor(x, device=dev)[None, :]
            for x in _det_jitter_tables(st, us * vs, phase))
        return uu, vv, det

    return scene.const(("area", ai, phase), build)


def draws_jitter(static: T.SceneStatic) -> bool:
    """Whether the scene draws random area-light jitter."""
    return bool(static.area_steps) and static.jitter is None


def draw_jitter(scene, rows: int, generator, out=None):
    """A level's random area-light jitter: one ``torch.rand((rows, S, 4))``
    per area light, in light order, from ``generator`` (into ``out``'s
    tensors when given). None when the scene draws none. Every level of a
    batch draws here at its whole width, in level order, run or not (see
    the module docstring), so the eager loop, the tile program and the
    train program consume one stream in one order."""
    if not draws_jitter(scene.static):
        return None
    if out is None:
        return tuple(torch.rand((rows, us * vs, 4), generator=generator,
                                device=scene.device)
                     for us, vs in scene.static.area_steps)
    for buf in out:
        torch.rand(buf.shape, generator=generator, out=buf)
    return out


def area_rays(static: T.SceneStatic, rows: int) -> int:
    """The shadow-sample rays that a level body of ``rows`` rows queries
    in its area-light stage: ``rows`` x S for each area light (S = usteps
    x vsteps)."""
    return rows * sum(us * vs for us, vs in static.area_steps)


def _area_light_contrib(scene, ai, over, eyev, normalv, base_color, mat_rows,
                        jitter, live=None, jitter_phase=0):
    """Shadow fraction + sampled Phong for area light ``ai``, all in
    [R, S] form: one shadow query of R x S rays through
    intersect.shadow_blocked (the mesh kernel sees one call of R*S rays),
    and Phong broadcasting [R, 1, ...] rows against [R, S, 3] samples.
    ``jitter``: this light's random draws [R, S, 4], or None in the
    deterministic sequence mode. :func:`shade_level` calls it inside the
    stage mark ``area_light`` (``utils/profiling.mark``)."""
    st = scene.static
    s_total = st.area_steps[ai][0] * st.area_steps[ai][1]
    corner = scene.alight_corner[ai]
    uvec = scene.alight_uvec[ai]
    vvec = scene.alight_vvec[ai]
    intensity = scene.alight_intensity[ai]

    uu, vv, det = _area_tables(scene, ai, jitter_phase)
    if det is not None:
        ju1, jv1, ju2, jv2 = det                                     # [1, S]
    else:
        ju1, jv1, ju2, jv2 = (jitter[..., k] for k in range(4))      # [R, S]

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


def base_color_plain(scene: T.Scene, over, rows, mat_rows):
    """The base colour of a level's shading points in plain torch: each
    point's pattern colour (:func:`pattern_color`) where the shading row's
    pattern id (column ``types.SHADE_PAT_ID`` of ``rows``, whose columns
    ``types.SHADE_INV`` are the inverse transform) is >= 0, else its
    material's colour. Counted in
    ``patterns_cuda.LAUNCHES["pattern_plain"]``."""
    PC.LAUNCHES["pattern_plain"] += 1
    pat_id = rows[:, T.SHADE_PAT_ID].to(scene.pattern_id.dtype)
    pat = pattern_color(scene, None, over, pid=pat_id,
                        inv=rows[:, T.SHADE_INV].reshape(-1, 4, 4))
    return torch.where((pat_id >= 0)[:, None], pat, mat_rows[:, T.MAT_COLOR])


def base_color_of(scene: T.Scene, over, rows, mat_rows):
    """:func:`shade_level`'s base colour at the points ``over`` [R, 3],
    from its shading rows ``rows`` [R, types.SHADE_NCOLS] and material
    rows ``mat_rows``:
    the kernel ``ops/patterns_cuda.pattern_base_color`` where
    ``patterns_cuda.takes_kernel`` holds (on the card, where no gradient
    flows through the stage: every frame), else
    :func:`base_color_plain`. The two give the same bits on the card."""
    if PC.takes_kernel(scene, over, rows, mat_rows):
        return PC.pattern_base_color(scene, over, rows, mat_rows)
    return base_color_plain(scene, over, rows, mat_rows)


def shade_level(scene: T.Scene, o, d, weight, jitter=None):
    """Trace + shade one wavefront level. ``jitter``: the level's random
    area-light draws (:func:`draw_jitter`, [R, S, 4] per area light); None
    when the scene draws none (see the module docstring).

    Returns (weighted surface color [R,3], reflect spawn, refract spawn),
    each spawn = (origin, direction, child_weight).
    """
    st = scene.static
    if jitter is None and draws_jitter(st):
        raise ValueError("the scene draws random area-light jitter: pass "
                         "the level's draws (render.draw_jitter)")
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
    # one tri->source row lookup shared by every per-primitive attribute,
    # and one table_gather of the per-source tables' concatenation
    tgid = I.transform_row(scene, gid)
    g_c = scene.inv_tf.shape[0]
    src_tab = torch.cat([
        scene.inv_tf.reshape(g_c, 16),
        scene.normal_mat.reshape(g_c, 9),
        scene.mat_id.to(torch.float32)[:, None],
        scene.pattern_id.to(torch.float32)[:, None],
    ], 1)                                    # [Gc, T.SHADE_NCOLS]
    rows = I.table_gather(src_tab, tgid)     # [R, T.SHADE_NCOLS]
    inv_rows = rows[:, T.SHADE_INV].reshape(-1, 4, 4)
    nmat_rows = rows[:, T.SHADE_NMAT].reshape(-1, 3, 3)
    mat_idx = rows[:, T.SHADE_MAT_ID].long()

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

    mat_rows = I.table_gather(scene.mat, mat_idx)
    base_color = base_color_of(scene, over, rows, mat_rows)

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
        with P.mark("area_light"):
            surface = surface + _area_light_contrib(
                scene, ai, over_sh, eyev, normalv, base_color, mat_rows,
                None if jitter is None else jitter[ai], live=has,
                jitter_phase=jitter_phase,
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


def _live_first(live, width: int):
    """The first ``width`` rows of a level in its stable live-first order,
    ``argsort(~live, stable=True)[:width]``, by a prefix sum in place of
    the sort: a live row goes to the slot after the live rows before it, a
    parked row after every live one, in the order of the parked rows. The
    rows past ``width`` all go to one spare slot, dropped: the result holds
    ``width`` indices, not the level's."""
    row = torch.arange(live.shape[0], device=live.device)
    ahead = torch.cumsum(live, 0)              # live rows up to each row
    slot = torch.where(live, ahead - 1, ahead[-1] + row - ahead)
    sel = row.new_empty(width + 1).scatter_(0, slot.clamp_max_(width), row)
    return sel[:width]


# The rows a packed level does not shade: zero colour and weights, parked
# origins and directions, in the order of its seven outputs (colour, then
# the reflect and the refract spawns' origin, direction and weight).
_UNSHADED = ((0.0,) * 3 + PARK_ORIGIN + PARK_DIR) * 2 + (0.0,) * 3


def _packed_shade_level(scene: T.Scene, o, d, w, jitter=None, *, width):
    """:func:`shade_level` of a level's live rays (any weight > 0) at
    ``width`` rows, the narrowest of R/16, R/4, R/2 and R that holds them
    (:func:`_packed_width` of the live count, which the caller has read):
    the level's first ``width`` rows in its stable live-first order
    (:func:`_live_first`: the live rays in the order of their rows, then
    parked padding), gathered once and shaded with the first ``width``
    rows of the level's area-light ``jitter`` (drawn at ``(R, S, 4)``), so
    that the k-th live ray takes draw row k. Each ray's result does not
    depend on its batch or its neighbours (K1's gates are conservative),
    so this is exact, and a seeded frame agrees with the whole-width one
    in distribution.

    Returns shade_level's outputs at R rows, in the rays' own order: the
    shaded rows copied, in one copy, into full-width outputs that start
    zero (colour, weights) and parked (origins, directions)."""
    r = o.shape[0]
    if jitter is not None:
        jitter = tuple(j[:width] for j in jitter)
    sel = _live_first((w > 0.0).any(-1), width)
    colored, refl, refr = shade_level(
        scene, *torch.stack([o, d, w]).index_select(1, sel), jitter)
    out = T.small_const(_UNSHADED, o.device, o.dtype).view(7, 1, 3)
    out = out.expand(7, r, 3).contiguous().index_copy_(
        1, sel, torch.stack([colored, *refl, *refr]))
    return out[0], tuple(out[1:4]), tuple(out[4:7])


def packs(static: T.SceneStatic, r: int, *, keeps: bool = True) -> bool:
    """Whether a level of ``r`` rays is compacted (:func:`level_width`),
    at R >= 4096 and R % 16 == 0:

    * mesh scenes of over 20,000 free triangles and area-light scenes (the
      JAX package's rule, ``render.py:406-410``);
    * blend scenes, where the level keeps nothing for a backward (not
      ``keeps``: the tile program, and ``color_at`` under
      ``torch.no_grad()``). A blend scene's levels double, and most of
      their rows are parked: on the benchmark's flagship scene at
      1280x720, in tiles of 16,384 rays, 40.9% of level 1's rows are
      live, 9.0% of level 2's, 5.4% of level 3's and 2.3% of level 4's,
      and a frame shades 2,967,552 rows packed against 15,056,896 whole.
      A level that keeps its tensors (``keeps``: autograd's, or a train
      program's, which holds every width's in a pool of its own) runs
      whole, so a train step holds no more memory than one whole-width
      body a level.

    Other scenes of small primitives keep their levels mostly live, and
    there the packing costs more than it saves."""
    big = static.counts[5] - static.n_csg_tris > 20000 or static.area_steps
    return bool((big or (static.has_blend and not keeps))
                and r >= 4096 and r % 16 == 0)


# The level steps. color_at's loop and core/tile_program.TileProgram run
# these same functions: the eager loop level by level, the program as one
# CUDA graph per tile, each (level, width) the body of a conditional node.

def level_width(static: T.SceneStatic, rows: int, n_live: int, *,
                keeps: bool = True):
    """The width a level of ``rows`` rays, ``n_live`` of them live, is
    shaded at: :func:`_packed_width` where :func:`packs` holds (``keeps``:
    whether the level keeps its tensors for a backward), else None (the
    whole level)."""
    return (_packed_width(rows, n_live) if packs(static, rows, keeps=keeps)
            else None)


# The branch of a level whose rays are all parked (the JAX package's
# ``_dead``, ``render.py:422-428``): :func:`dead_step`.
DEAD = "dead"


def level_branches(static: T.SceneStatic, rows: int, *,
                   dead: bool = False, keeps: bool = True) -> tuple:
    """The widths a level of ``rows`` rays may take, one conditional body
    each: R/16, R/4, R/2 and R where :func:`packs` holds, else (None,),
    the whole level; with ``dead``, then :data:`DEAD` (the train
    program's pass-through of a level with no live ray). ``keeps``:
    whether the level keeps its tensors for a backward, as a train
    program's do; the tile program's keep nothing, so a blend scene's
    levels take the four widths there and one whole body in a train
    program (:func:`packs`)."""
    out = ((rows // 16, rows // 4, rows // 2, rows)
           if packs(static, rows, keeps=keeps) else (None,))
    return out + (DEAD,) if dead else out


def level_rows(static: T.SceneStatic, rows: int, limit: int) -> list:
    """Rays of each level that may run, from level 0 (``rows``) to the
    last: ``limit`` in a scene that spawns, else 0."""
    out = [rows]
    if spawns(static):
        for _ in range(limit):
            out.append(spawn_rows(static, out[-1]))
    return out


def shade_step(scene: T.Scene, o, d, w, jitter, *, width):
    """One level's trace + shade at ``width`` (:func:`level_width`):
    (colored, reflect spawn, refract spawn), in the rays' order. At width
    None or R the level runs whole; narrower, its live rays alone
    (:func:`_packed_shade_level`)."""
    if width is None or width == o.shape[0]:
        return shade_level(scene, o, d, w, jitter=jitter)
    return _packed_shade_level(scene, o, d, w, jitter=jitter, width=width)


def spawns(static: T.SceneStatic) -> bool:
    """Whether a level spawns rays for the next one."""
    return static.has_reflective or static.has_transparency


def spawn_rows(static: T.SceneStatic, rows: int) -> int:
    """Rays of the next level after a level of ``rows`` rays: blend
    scenes concatenate the two spawn streams (:func:`spawn_step`)."""
    return 2 * rows if static.has_blend else rows


def spawn_step(static: T.SceneStatic, refl, refr):
    """The spawn merge: the next level's (o, d, w) from a level's reflect
    and refract spawns (:func:`spawns` must hold), zero-weight rays
    parked."""
    out = []
    if static.has_reflective:
        out.append(refl)
    if static.has_transparency:
        out.append(refr)
    if len(out) == 2 and not static.has_blend:
        # No material is both reflective and transparent: the two spawn
        # weights are disjoint per ray, so select instead of concatenate
        # and the level width stays R (exact).
        (ro, rd, rw), (fo, fd, fw) = out
        take_r = (rw > 0.0).any(-1, keepdim=True)
        o = torch.where(take_r, ro, fo)
        d = torch.where(take_r, rd, fd)
        w = rw + fw
    else:
        o = torch.cat([s[0] for s in out], 0)
        d = torch.cat([s[1] for s in out], 0)
        w = torch.cat([s[2] for s in out], 0)
    # park zero-weight spawns: they cost the mesh kernel nothing
    o, d = park_rays(o, d, (w > 0.0).any(-1))
    return o, d, w


def live_count(w):
    """Live rays of a level (any weight > 0), as a device scalar."""
    return (w > 0.0).any(-1).sum()


def level_step(scene: T.Scene, level: int, limit: int, o, d, w, img,
               jitter, *, width):
    """One level of a batch as the compiled programs run it: the shade
    (:func:`shade_step`), its colours added to the image (a blend level's
    2^L blocks of R rows each) and, below ``limit`` in a scene that
    spawns, the next level's rays (:func:`spawn_step`) and their live
    count. Returns the outputs by name: ``img``, ``o``, ``d``, ``w`` and
    ``live``."""
    st = scene.static
    colored, refl, refr = shade_step(scene, o, d, w, jitter, width=width)
    out = {"img": img + colored.reshape(-1, img.shape[0], 3).sum(0)}
    if level < limit and spawns(st):
        o, d, w = spawn_step(st, refl, refr)
        out.update(o=o, d=d, w=w, live=live_count(w))
    return out


def dead_step(static: T.SceneStatic, level: int, limit: int, rows: int,
              img):
    """:func:`level_step`'s outputs for a level of ``rows`` rays that are
    all parked (the JAX package's ``_dead`` branch,
    ``render.py:422-428``): the image passed through as it is (the caller
    copies it: a copy, not an added zero, keeps a -0.0), and below
    ``limit`` in a scene that spawns zero-weight spawns, parked, and a
    live count of 0."""
    out = {"img": img}
    if level < limit and spawns(static):
        n, dev = spawn_rows(static, rows), img.device
        out.update(o=T.small_const(PARK_ORIGIN, dev, img.dtype).expand(n, 3),
                   d=T.small_const(PARK_DIR, dev, img.dtype).expand(n, 3),
                   w=torch.zeros((n, 3), dtype=img.dtype, device=dev),
                   live=torch.zeros((), dtype=torch.int64, device=dev))
    return out


def quantize_u8(c):
    """floor(clip(x, 0, 1) * 255 + 0.5) as uint8 (canvas.quantize_u8)."""
    return torch.floor(c.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _remat(step, scene, o, d, w, jitter):
    """``step(scene, o, d, w, jitter)`` under ``torch.utils.checkpoint``:
    the backward pass recomputes the level instead of keeping its
    intermediates. The level's jitter is drawn before it and passed in, so
    the recompute reads the same draws and the generator moves on once."""
    return checkpoint(step, scene, o, d, w, jitter, use_reentrant=False)


def color_at(scene: T.Scene, origins, directions, limit=None,
             generator=None, *, remat=False):
    """world.rs:91-99 over a ray batch, bounce tree unrolled level by
    level. Once every ray of a level has zero weight, that level and every
    later one contribute nothing, so the loop stops there. ``generator``:
    the area-light jitter's (None: seed 0; see the module docstring).

    Levels after the first are compacted where :func:`packs` says so
    (:func:`_packed_shade_level`): the live count, read once per level for
    the skip, picks the width (:func:`level_width`). A blend scene's
    levels pack only under ``torch.no_grad()``, where a level keeps
    nothing for a backward (``render(..., graphs=False)``); with
    gradients on they run whole, as in a train program. Every level draws
    its jitter at its whole width, run or not (see the module docstring).
    A packed level's outputs come back in its rays' order. With the span
    recorder on, each level that runs adds its :func:`area_rays` at its
    width to the open root span's ``attrs["area_rays"]``.

    ``remat=True`` runs every level under ``torch.utils.checkpoint``
    (:func:`_remat`): the backward pass recomputes each level's trace, K1
    included, instead of storing its intermediates, so only the level
    inputs (o, d, w and the jitter) live across it. A blend scene's
    deepest level is 16R wide at depth 4. The forward values are the same
    either way.

    The steps are those that core/tile_program.TileProgram replays as CUDA
    graphs (``render``'s default path)."""
    st = scene.static
    if draws_jitter(st):
        generator = _seeded(generator, origins.device)
    if limit is None:
        limit = st.recursion_limit
    r = origins.shape[0]
    img = torch.zeros((r, 3), device=origins.device)

    o, d = origins, directions
    w = torch.ones((r, 3), device=origins.device)
    rows = level_rows(st, r, limit)
    keeps = torch.is_grad_enabled()
    drawn = 0
    for level in range(len(rows)):
        width = None
        if level > 0:
            n_live = int(live_count(w))   # the level's one sync
            if n_live == 0:
                break
            width = level_width(st, rows[level], n_live, keeps=keeps)
        jitter = draw_jitter(scene, rows[level], generator)
        drawn += 1
        step = functools.partial(shade_step, width=width)
        if remat:
            colored, refl, refr = _remat(step, scene, o, d, w, jitter)
        else:
            colored, refl, refr = step(scene, o, d, w, jitter)
        if st.area_steps:
            P.add_to_root("area_rays", area_rays(st, width or rows[level]))
        img = img + colored.reshape(-1, r, 3).sum(0)
        if level == len(rows) - 1:
            break
        o, d, w = spawn_step(st, refl, refr)
    for n in rows[drawn:]:      # the levels not run draw theirs too
        draw_jitter(scene, n, generator)
    return img


def tile_rays(inv, consts, idx, hsize):
    """Primary rays for flat pixel ids, on the device (camera.rs:45-64).

    inv: [4,4] inverse camera transform; consts: [3] = (half_width,
    half_height, pixel_size); idx: [R] flat pixel ids (py*hsize+px);
    hsize: the frame's width, an int or an int64 scalar tensor.
    Returns (origins [R,3], directions [R,3]).

    Rounded as the JAX package's ``tile_rays`` rounds op by op on the CPU,
    so the directions are its own bit for bit: XLA sums the einsum's four
    rounded products pairwise, ``(wx i0 + wy i1) + (i3 - i2)`` (the -1 and
    1 columns are exact), and ``jnp.linalg.norm`` takes the squares as a
    chain of fused multiply-adds, which :func:`intersect.mat3_apply` rounds
    the same way (a [R, 1, 3] "matrix" of d against d). Its square root is
    taken in f64 on the CPU: torch's vectorized f32 sqrt there is not
    correctly rounded (about 0.6% of values differ in the last bit); the
    card's is.
    """
    half_w, half_h, psize = consts[0], consts[1], consts[2]
    origin = inv[:3, 3]
    pxf = (idx % hsize).to(torch.float32)
    pyf = (idx // hsize).to(torch.float32)
    wx = half_w - (pxf + 0.5) * psize
    wy = half_h - (pyf + 0.5) * psize
    pw = ((wx[:, None] * inv[:3, 0] + wy[:, None] * inv[:3, 1])
          + (inv[:3, 3] - inv[:3, 2]))
    d = pw - origin
    n2 = I.mat3_apply(d[:, None, :], d)
    d = d / (torch.sqrt(n2) if n2.is_cuda else torch.sqrt(n2.double()).float())
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


@functools.lru_cache(maxsize=8)
def _block_order(h, w, block):
    """Flat pixel indices in square-block-major order. Each consecutive
    256 ids form one 16x16 pixel square: one CTA of the mesh kernel, whose
    chunk gates then see a tight ray frustum. Built once per (h, w,
    block) and shared, so the array is read-only."""
    block = max(min(block, h, w), 1)
    cols = []
    for y0 in range(0, h, block):
        for x0 in range(0, w, block):
            ys = np.arange(y0, min(y0 + block, h))
            xs = np.arange(x0, min(x0 + block, w))
            cols.append((ys[:, None] * w + xs[None, :]).ravel())
    order = np.concatenate(cols)
    order.setflags(write=False)
    return order


def _order_tiles(h, w, tile, device):
    """(host order [n], idx_tiles [n_tiles, tile] on device); padding
    repeats pixel 0."""
    order = _block_order(h, w, 16)     # 16x16 = one 256-ray subtile
    padded = np.pad(order, (0, -(h * w) % tile))       # a writable copy
    return order, torch.as_tensor(padded.reshape(-1, tile), device=device)


def put_tile(image, ti, idx, colors):
    """Writes tile ``ti``'s ``colors`` [tile, 3] to their pixels of
    ``image`` [n, 3] (``idx``: the tile's pixel ids, a row of
    :func:`_order_tiles`' ``idx_tiles``), the last tile's padding
    dropped: a frame's tiles put so are the frame in image order."""
    k = min(len(idx), len(image) - ti * len(idx))
    image.index_copy_(0, idx[:k], colors[:k])


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
           generator=None, graphs=True):
    """Full frame -> float32 [vsize, hsize, 3] numpy image, on the scene's
    device (``build_scene`` puts it on ``cuda`` unless told otherwise).

    ``quantize=True`` returns uint8 instead, quantized on the device with
    the formula of :func:`canvas.quantize_u8`, floor(clip(x,0,1)*255+0.5).
    ``generator``: a ``torch.Generator`` on the scene's device for the
    area-light jitter, which the tiles draw from in turn (None: seed 0;
    see the module docstring).

    ``graphs=True`` runs each tile through the scene's
    :class:`~raytracer_tpu_torch.core.tile_program.TileProgram`: on cuda,
    one CUDA graph launch per tile (captured at first use), its level skip
    and packed widths taken on the card, nothing read back until the
    frame; on the CPU, the same steps on the same buffers without
    capture. ``graphs=False`` runs :func:`color_at` tile by tile, every op
    launched from the host, one live-count read per level. Both give the
    same frame bit for bit. The frame crosses to the host once.

    The tiles follow the 16x16 block order (:func:`_order_tiles`); each
    tile's colours go to their pixels on the device (:func:`put_tile`),
    so the frame crosses in image order. The tile program keeps the
    order's pixel ids on the device for the next frames of the same size
    (:meth:`~raytracer_tpu_torch.core.tile_program.TileProgram.order`).

    Matmuls and convolutions are held to full f32 (:func:`full_f32`).

    With the span recorder on (``utils/profiling``) a frame records the
    span ``frame`` and its phases: ``frame.prepare`` (everything before the
    first tile's launch) and ``frame.scatter`` (the host's reshape), and
    through the tile program ``frame.capture`` (its first use),
    ``frame.enqueue``, ``frame.wait`` (the host blocked on the card) and
    ``frame.settle`` (the level logs read).
    """
    with P.span("frame"):
        with P.span("frame.prepare"):
            full_f32()
            device = scene.device
            if tile_rays is None:
                tile_rays = pick_tile_rays(scene.static)
            n = camera.vsize * camera.hsize
            tile = min(tile_rays, n)
            inv, consts = camera_consts(camera, device)
            limit = scene.static.recursion_limit
            if draws_jitter(scene.static):
                generator = _seeded(generator, device)
            if graphs:
                from raytracer_tpu_torch.core.tile_program import program_for
                prog = program_for(scene, tile, limit)
                idx_tiles = prog.order(camera.vsize, camera.hsize)
                prog.set_camera(inv, consts, camera.hsize)
            else:
                _, idx_tiles = _order_tiles(camera.vsize, camera.hsize, tile,
                                            device)
        with torch.no_grad():
            if graphs:
                frame = prog.to_host(prog.frame(scene, idx_tiles, quantize,
                                                generator, pixels=n))
            else:
                frame = torch.empty(
                    (n, 3), dtype=torch.uint8 if quantize else torch.float32,
                    device=device)
                for ti, idx in enumerate(idx_tiles):
                    o, d = _primary_rays(inv, consts, idx, camera.hsize)
                    c = color_at(scene, o, d, limit, generator)
                    put_tile(frame, ti, idx, quantize_u8(c) if quantize else c)
                frame = frame.cpu()
        with P.span("frame.scatter"):
            return frame.numpy().reshape(camera.vsize, camera.hsize, 3)
