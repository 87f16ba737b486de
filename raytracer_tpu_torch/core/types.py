"""Device-side scene representation: SoA tensors, one table per concept.

Counterpart of ``raytracer_tpu/core/types.py``. The reference's
enum-of-structs + slotmap registries become flat, padded tables:

* every primitive gets a global id ``gid``; compact per-source tables hold
  material, pattern id, shadow flag and the composed world->object inverse
  transform (group hierarchies are flattened at compile time);
* triangles are stored in WORLD space (vertices pre-transformed on the
  host), so Moller-Trumbore runs on world rays with no per-ray matrix work;
* smooth-triangle normals are pre-multiplied by the normal matrix;
* static facts (family counts, CSG node order, area-light step counts,
  feature flags) live in the frozen :class:`SceneStatic`.

The field names, shapes and dtypes of :class:`Scene` are those of the JAX
package's ``Scene``, so :func:`scene_from_arrays` carries its tables over
one to one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

# Family order for gid assignment. Offsets are cumulative counts.
FAMILIES = ("sphere", "plane", "cube", "cylinder", "cone", "triangle")

# Pattern kinds (patterns.rs enum)
PAT_STRIPED, PAT_GRADIENT, PAT_RING, PAT_CHECKER, PAT_XYZRGB, PAT_TEXTURE, PAT_CUBEMAP = range(7)
# UV mapping kinds (texture_map.rs UvMapping)
MAP_SPHERICAL, MAP_PLANAR, MAP_CYLINDRICAL = range(3)
# UV pattern kinds (uv_pattern.rs enum)
UV_CHECKER, UV_ALIGN, UV_IMAGE = range(3)
# CSG ops (csg.rs CsgOp)
CSG_UNION, CSG_INTERSECT, CSG_DIFFERENCE = range(3)

# Material table columns
MAT_COLOR = slice(0, 3)
MAT_AMBIENT, MAT_DIFFUSE, MAT_SPECULAR, MAT_SHININESS = 3, 4, 5, 6
MAT_REFLECTIVE, MAT_TRANSPARENCY, MAT_REFRACTIVE = 7, 8, 9
MAT_NCOLS = 10

# Shading row columns (render.shade_level's one gather of the per-source
# tables; ops/patterns_cuda.py passes the pattern stage's to its kernel)
SHADE_INV = slice(0, 16)       # the inverse transform, row-major 4x4
SHADE_NMAT = slice(16, 25)     # the normal matrix, row-major 3x3
SHADE_MAT_ID, SHADE_PAT_ID = 25, 26
SHADE_NCOLS = 27


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Hashable static scene facts (the JAX package's SceneStatic)."""

    counts: tuple  # (n_sphere, n_plane, n_cube, n_cylinder, n_cone, n_triangle)
    # ((usteps, vsteps), ...) one per area light; point lights need none.
    area_steps: tuple = ()
    # CSG nodes in bottom-up order: (op_code, bit_index, root_bit_index).
    csg_nodes: tuple = ()
    # ((gid, under_mask, left_mask), ...) for every primitive in a CSG tree.
    csg_members: tuple = ()
    # Leading count of triangles that live inside CSG trees.
    n_csg_tris: int = 0
    has_reflective: bool = False
    has_transparency: bool = False
    # Some material is both reflective and transparent (Schlick blend):
    # spawn streams are concatenated instead of merged (render.color_at).
    has_blend: bool = False
    # A free (non-CSG) mesh triangle is transparent: the n1/n2 walk needs
    # the nearest-behind triangle column (intersect.candidate_hits).
    mesh_transparent: bool = False
    # Deterministic area-light jitter sequence; None = seeded random.
    jitter: tuple | None = None
    # Every triangle source casts shadows: mesh shadow rays are any-hit.
    mesh_all_shadow: bool = True
    # All triangle sources share one refractive index -> that value.
    mesh_uniform_refr: float | None = None
    # Every material has refractive_index == 1.0: the n1/n2 walk is the
    # constant (1, 1) and shade_level takes the nearest hit only.
    all_ri_one: bool = False
    recursion_limit: int = 4

    @property
    def offsets(self) -> tuple:
        off, acc = [], 0
        for c in self.counts:
            off.append(acc)
            acc += c
        return tuple(off)

    @property
    def n_prims(self) -> int:
        return sum(self.counts)

    def family_range(self, name: str) -> tuple:
        i = FAMILIES.index(name)
        return self.offsets[i], self.counts[i]


@dataclasses.dataclass
class Scene:
    """All scene data as tensors on one device; ``static`` is metadata.

    Per-primitive attribute tables use COMPACT indexing: non-triangle gids
    first, then one row per triangle SOURCE (an individual triangle or a
    whole mesh block); triangle gid -> row via ``tri_tf_id``
    (intersect.transform_row)."""

    mat: Any            # f32 [M, MAT_NCOLS] unique material rows
    mat_id: Any         # i32 [Gn + n_tf] material row per compact row
    pattern_id: Any     # i32 [Gn + n_tf]   (-1 = none)
    shadow: Any         # bool [Gn + n_tf]  casts shadows (world.rs:107)
    inv_tf: Any         # f32 [Gn + n_tf, 4, 4] world -> object
    normal_mat: Any     # f32 [Gn + n_tf, 3, 3] local normals -> world
    cyl_min: Any        # f32 [Ncy]
    cyl_max: Any        # f32 [Ncy]
    cyl_closed: Any     # bool [Ncy]
    cone_min: Any       # f32 [Nco]
    cone_max: Any       # f32 [Nco]
    cone_closed: Any    # bool [Nco]
    tri_p1: Any         # f32 [Nt, 3] world space
    tri_e1: Any         # f32 [Nt, 3]
    tri_e2: Any         # f32 [Nt, 3]
    tri_shade: Any      # f32 [Nt, 13] n1|n2|n3|flat_n|smooth flag
    tri_tf_id: Any      # i32 [max(Nt,1)] transform row per triangle
    # Per-triangle Moller-Trumbore det threshold EPSILON * |det A| of the
    # instance transform (the reference tests |det| in OBJECT space).
    tri_det_eps: Any    # f32 [Nt]
    plight_pos: Any     # f32 [Lp, 3]
    plight_intensity: Any  # f32 [Lp, 3]
    alight_corner: Any  # f32 [La, 3]
    alight_uvec: Any    # f32 [La, 3]  (full_uvec / usteps, lights.rs:95)
    alight_vvec: Any    # f32 [La, 3]
    alight_pos: Any     # f32 [La, 3]  corner + (full_u + full_v)/2
    alight_intensity: Any  # f32 [La, 3]
    pat_kind: Any       # i32 [P]
    pat_a: Any          # f32 [P, 3]
    pat_b: Any          # f32 [P, 3]
    pat_inv: Any        # f32 [P, 4, 4]
    pat_map: Any        # i32 [P] uv mapping kind
    pat_uv: Any         # i32 [P, 6] uv-pattern ids
    uv_kind: Any        # i32 [U]
    uv_wh: Any          # f32 [U, 2]
    uv_colors: Any      # f32 [U, 5, 3]
    uv_image: Any       # i32 [U]
    images: Any         # f32 [I, Hmax, Wmax, 3]
    image_wh: Any       # i32 [I, 2]  (width, height) of each image
    # Free-triangle planes in the mesh kernel's layout + chunk/supergroup
    # AABBs (ops/mesh_cuda.py), packed once at scene build whenever the
    # scene has a free triangle. None otherwise.
    mesh_planes: Any = None    # f32 [n_super, SG, N_PLANES*CHUNK]
    mesh_bb_chunk: Any = None  # f32 [6, n_chunks]
    mesh_bb_super: Any = None  # f32 [6, n_super]
    static: SceneStatic = None

    @property
    def device(self) -> torch.device:
        return self.mat.device

    def family_slice(self, name: str, table):
        """The rows of ``table`` (indexed by gid) that belong to primitive
        family ``name`` (:data:`FAMILIES`)."""
        off, n = self.static.family_range(name)
        return table[off : off + n]

    def const(self, key, build):
        """``build()`` (tensors on this scene's device made from the static
        facts: index columns, masks, sample tables), made on the first call
        for ``key`` and kept on the scene. A level then uploads nothing, so
        it runs as a CUDA graph (core/tile_program.py), and the eager path
        skips the same copies. The cache is not a field: ``replace`` and
        ``scene_from_arrays`` start a scene without it."""
        cache = self.__dict__.setdefault("_consts", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]


@functools.lru_cache(maxsize=None)
def small_const(values: tuple, device: torch.device,
                dtype=torch.float32) -> torch.Tensor:
    """The tensor of ``values`` on ``device``, uploaded once per process
    (park sentinels, unit axes). Read only: callers never write it."""
    return torch.tensor(values, dtype=dtype, device=device)


ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(Scene) if f.name != "static"
)


def scene_from_arrays(arrays: dict, static: dict, device) -> Scene:
    """Scene tables given as numpy arrays (e.g. the leaves of a JAX
    ``Scene``, read out with ``np.asarray``) and the static facts as a
    dict (``dataclasses.asdict(scene.static)``) -> a torch :class:`Scene`
    on ``device``.

    The mesh kernel's packed planes are built here when the arrays carry
    none (the JAX builder packs only meshes of 1024+ free triangles)."""
    from raytracer_tpu_torch.ops.mesh_cuda import pack_tri_planes_np

    st = SceneStatic(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in static.items()
    })
    arrs = {k: arrays.get(k) for k in ARRAY_FIELDS}
    nt_free = st.counts[5] - st.n_csg_tris
    if arrs["mesh_planes"] is None and nt_free > 0:
        sl = slice(st.n_csg_tris, st.counts[5])
        planes, (bbc, bbs) = pack_tri_planes_np(
            np.asarray(arrs["tri_p1"])[sl], np.asarray(arrs["tri_e1"])[sl],
            np.asarray(arrs["tri_e2"])[sl], np.asarray(arrs["tri_det_eps"])[sl],
        )
        arrs.update(mesh_planes=planes, mesh_bb_chunk=bbc, mesh_bb_super=bbs)
    return Scene(
        **{k: None if v is None else torch.as_tensor(np.array(v), device=device)
           for k, v in arrs.items()},   # copies: the arrays may be read-only
        static=st,
    )
