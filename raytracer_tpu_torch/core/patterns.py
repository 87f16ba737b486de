"""Pattern evaluation, branchless.

Counterpart of ``raytracer_tpu/core/patterns.py``. The reference
dispatches per point through Pattern/UvPattern enums (patterns.rs:79-91,
uv_pattern.rs, cube_map.rs, texture_map.rs); here every pattern kind is
evaluated for the whole shading batch and where-selected by kind.

Rust ``%`` on floats keeps the dividend's sign (:func:`_rust_rem`); for the
``x % 2 == 0`` parity tests a floored mod (``torch.remainder``) gives the
same equality results, and ``rem_euclid`` maps to it directly.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.core.intersect import (
    mat3_apply, select_col, table_gather, transform_row,
)

PI = 3.14159265358979323846


def _rust_rem(x, m):
    """Rust f32 % (remainder with dividend's sign)."""
    return x - torch.trunc(x / m) * m


def pattern_color(scene: T.Scene, gid, world_point, tgid=None, pid=None,
                  inv=None):
    """pattern_at_shape (patterns.rs:79-91) for a batch of shading points.

    gid [R], world_point [R,3] -> color [R,3]. Rays whose material has no
    pattern get pattern 0's color; callers select with pattern_id >= 0.
    """
    if pid is None or inv is None:
        if tgid is None:
            tgid = transform_row(scene, gid)
        if pid is None:
            pid = table_gather(scene.pattern_id, tgid)
        if inv is None:
            inv = table_gather(scene.inv_tf, tgid)         # [R,4,4]
    pid = pid.clamp_min(0).long()
    obj_p = mat3_apply(inv[:, :3, :3], world_point) + inv[:, :3, 3]
    pinv = table_gather(scene.pat_inv, pid)
    p = mat3_apply(pinv[:, :3, :3], obj_p) + pinv[:, :3, 3]

    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    a = table_gather(scene.pat_a, pid)
    b = table_gather(scene.pat_b, pid)
    kind = table_gather(scene.pat_kind, pid)

    # striped.rs:28-34
    striped = torch.where((torch.remainder(torch.floor(x), 2.0) == 0.0)[:, None], a, b)
    # gradient.rs:28-32
    frac = (x - torch.floor(x))[:, None]
    gradient = a + (b - a) * frac
    # ring.rs:28-39
    ring_par = torch.remainder(torch.floor(torch.sqrt(x * x + z * z)), 2.0) == 0.0
    ring = torch.where(ring_par[:, None], a, b)
    # checker.rs:28-36
    chk_par = torch.remainder(
        torch.floor(x) + torch.floor(y) + torch.floor(z), 2.0) == 0.0
    checker = torch.where(chk_par[:, None], a, b)
    # xyz_rgb.rs:24-26
    xyz = p

    # texture_map.rs: pick the uv mapping, then the uv pattern
    tex_u, tex_v = _uv_map(table_gather(scene.pat_map, pid), p)
    texture = _uv_pattern_at(scene, table_gather(scene.pat_uv[:, 0], pid),
                             tex_u, tex_v)

    # cube_map.rs:81-137
    cubemap = _cube_map_color(scene, pid, p)

    out = striped
    for code, val in (
        (T.PAT_GRADIENT, gradient), (T.PAT_RING, ring), (T.PAT_CHECKER, checker),
        (T.PAT_XYZRGB, xyz), (T.PAT_TEXTURE, texture), (T.PAT_CUBEMAP, cubemap),
    ):
        out = torch.where((kind == code)[:, None], val, out)
    return out


def _uv_map(mapping, p):
    """texture_map.rs:69-114 spherical/planar/cylindrical maps."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    # spherical
    theta = torch.atan2(x, z)
    radius = torch.sqrt(x * x + y * y + z * z)
    phi = torch.acos(torch.clamp(
        y / torch.where(radius == 0, 1.0, radius), -1.0, 1.0))
    sph_u = 1.0 - (theta / (2.0 * PI) + 0.5)
    sph_v = 1.0 - phi / PI
    # planar
    pla_u = torch.remainder(x, 1.0)
    pla_v = torch.remainder(z, 1.0)
    # cylindrical
    cyl_u = sph_u
    cyl_v = torch.remainder(y, 1.0)
    u = torch.where(mapping == T.MAP_PLANAR, pla_u,
                    torch.where(mapping == T.MAP_CYLINDRICAL, cyl_u, sph_u))
    v = torch.where(mapping == T.MAP_PLANAR, pla_v,
                    torch.where(mapping == T.MAP_CYLINDRICAL, cyl_v, sph_v))
    return u, v


def _uv_pattern_at(scene: T.Scene, uv_id, u, v):
    """uv_pattern.rs: checker / align-check / image, batched."""
    uid = uv_id.clamp_min(0).long()
    kind = table_gather(scene.uv_kind, uid)
    w = table_gather(scene.uv_wh[:, 0], uid)
    h = table_gather(scene.uv_wh[:, 1], uid)
    colors = table_gather(scene.uv_colors, uid)            # [R,5,3]

    # UvChecker (uv_pattern.rs:44-53)
    par = torch.remainder(torch.floor(u * w) + torch.floor(v * h), 2.0) == 0.0
    checker = torch.where(par[:, None], colors[:, 0], colors[:, 1])

    # UvAlignCheck (uv_pattern.rs:89-104)
    main, ul, ur, bl, br = (colors[:, i] for i in range(5))
    align = main
    align = torch.where(((v > 0.8) & (u < 0.2))[:, None], ul, align)
    align = torch.where(((v > 0.8) & (u > 0.8))[:, None], ur, align)
    align = torch.where(((v < 0.2) & (u < 0.2))[:, None], bl, align)
    align = torch.where(((v < 0.2) & (u > 0.8))[:, None], br, align)

    # UvImage (uv_pattern.rs:120-133): nearest neighbor, v flipped.
    img_id = table_gather(scene.uv_image, uid).clamp_min(0).long()
    iw = table_gather(scene.image_wh[:, 0], img_id).to(torch.float32)
    ih = table_gather(scene.image_wh[:, 1], img_id).to(torch.float32)
    vv = 1.0 - v
    px = torch.floor(u * (iw - 1.0) + 0.5).to(torch.int64)
    py = torch.floor(vv * (ih - 1.0) + 0.5).to(torch.int64)
    px = px.clamp(0, scene.images.shape[2] - 1)
    py = py.clamp(0, scene.images.shape[1] - 1)
    # the texels as a table of rows, through table_gather, so that their
    # gradient is its reduction too (every ray of a scene without an
    # image reads one texel)
    _, ih_max, iw_max, _ = scene.images.shape
    image = table_gather(scene.images.reshape(-1, 3),
                         (img_id * ih_max + py) * iw_max + px)

    out = torch.where((kind == T.UV_ALIGN)[:, None], align, checker)
    out = torch.where((kind == T.UV_IMAGE)[:, None], image, out)
    return out


def _cube_map_color(scene: T.Scene, pid, p):
    """cube_map.rs: face select by dominant coordinate + per-face uv."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    coord = torch.maximum(torch.maximum(x.abs(), y.abs()), z.abs())

    # Face indices into pat_uv slots: left,right,front,back,up,down = 0..5
    # Reference if-chain order (cube_map.rs:87-100): Right, Left, Up, Down,
    # Front, else Back.
    face = torch.full(x.shape, 3, dtype=torch.int64, device=x.device)
    face = torch.where(coord == z, 2, face)                    # Front
    face = torch.where(coord == -y, 5, face)                   # Down
    face = torch.where(coord == y, 4, face)                    # Up
    face = torch.where(coord == -x, 0, face)                   # Left
    face = torch.where(coord == x, 1, face)                    # Right

    def rem2(val):
        return _rust_rem(val, 2.0)

    u_faces = torch.stack([
        rem2(z + 1.0) / 2.0,        # Left
        rem2(1.0 - z) / 2.0,        # Right
        rem2(x + 1.0) / 2.0,        # Front
        rem2(1.0 - x) / 2.0,        # Back
        rem2(x + 1.0) / 2.0,        # Up
        rem2(x + 1.0) / 2.0,        # Down
    ], -1)
    v_faces = torch.stack([
        rem2(y + 1.0) / 2.0,        # Left
        rem2(y + 1.0) / 2.0,        # Right
        rem2(y + 1.0) / 2.0,        # Front
        rem2(y + 1.0) / 2.0,        # Back
        rem2(1.0 - z) / 2.0,        # Up
        rem2(z + 1.0) / 2.0,        # Down
    ], -1)
    u = select_col(u_faces, face)
    v = select_col(v_faces, face)
    uv_id = select_col(table_gather(scene.pat_uv, pid), face)
    return _uv_pattern_at(scene, uv_id, u, v)
