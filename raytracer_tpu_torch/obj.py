"""Wavefront OBJ parser -> Group of triangle Meshes.

Counterpart of ``raytracer_tpu/obj.py`` (the reference's obj.rs:8-41):
one array-backed :class:`specs.Mesh` per OBJ group, polygon faces
fan-triangulated, vertex normals on all three corners -> smooth shading,
else flat; one material applied to every triangle.

Parsing runs through the native tokenizer (``native/io_native.cpp``, see
:mod:`raytracer_tpu_torch.native`) when it builds, and otherwise through
:func:`_parse_obj_python`, the plain version of the same function, which
the tests hold the native one against.

Supported face syntax: ``f v``, ``f v/vt``, ``f v//vn``, ``f v/vt/vn``,
with negative (relative) indices as in the OBJ spec.
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu_torch import native
from raytracer_tpu_torch.scene import specs as S

# source text -> per-OBJ-group geometry arrays. Instanced scenes (the
# dragons layout references one OBJ from 168 groups) re-read the same
# file per instance; geometry is material-independent, so one parse
# serves every instance. The arrays are shared read-only (the builder
# never writes to spec arrays). Keyed by the full text; a small LRU.
_GEOM_CACHE: dict = {}
_GEOM_CACHE_MAX = 8


def _obj_geometry(source: str):
    got = _GEOM_CACHE.get(source)
    if got is not None:
        return got
    parsed = native.parse_obj_arrays(source)
    if parsed is None:
        parsed = _parse_obj_python(source)
    verts, norms, tri_v, tri_n, tri_g = parsed

    groups = []
    if len(tri_v):
        for g in np.unique(tri_g):
            sel = tri_g == g
            tv = tri_v[sel]                               # [N,3]
            tn = tri_n[sel]
            p = verts[tv]                                 # [N,3,3]
            smooth = (tn >= 0).all(axis=1)
            n = np.zeros_like(p)
            if smooth.any():
                safe = np.maximum(tn, 0)
                n = np.where(smooth[:, None, None], norms[safe], 0.0)
            groups.append((p, n, smooth))
    if len(_GEOM_CACHE) >= _GEOM_CACHE_MAX:
        _GEOM_CACHE.pop(next(iter(_GEOM_CACHE)))
    _GEOM_CACHE[source] = groups
    return groups


def parse_obj(source, material: S.Material | None = None) -> S.Group:
    """Parse OBJ text (str, bytes or file-like) into a Group of Meshes."""
    if hasattr(source, "read"):
        source = source.read()
    if isinstance(source, bytes):
        source = source.decode("utf-8", errors="replace")
    if material is None:
        material = S.Material()

    out = S.Group()
    for p, n, smooth in _obj_geometry(source):
        out.children.append(
            S.Mesh(p=p, n=n, smooth=smooth, material=material)
        )
    return out


def _parse_obj_python(source: str):
    """The plain version, with the native parser's array output."""
    vertices, normals = [], []
    tri_v, tri_n, tri_g = [], [], []
    group = 0
    group_has = False

    for raw in source.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            vertices.append([float(x) for x in parts[1:4]])
        elif tag == "vn":
            normals.append([float(x) for x in parts[1:4]])
        elif tag in ("g", "o"):
            if group_has:
                group += 1
                group_has = False
        elif tag == "f":
            corners = [_parse_corner(tok, len(vertices), len(normals))
                       for tok in parts[1:]]
            for i in range(1, len(corners) - 1):
                a, b, c = corners[0], corners[i], corners[i + 1]
                tri_v.append([a[0], b[0], c[0]])
                tri_n.append([a[1], b[1], c[1]])
                tri_g.append(group)
                group_has = True

    return (
        np.asarray(vertices, np.float32).reshape(-1, 3),
        np.asarray(normals, np.float32).reshape(-1, 3),
        np.asarray(tri_v, np.int64).reshape(-1, 3),
        np.asarray(tri_n, np.int64).reshape(-1, 3),
        np.asarray(tri_g, np.int64),
    )


def _parse_corner(token: str, nv: int, nn: int):
    """Face corner ``v[/vt[/vn]]`` -> (vertex_idx, normal_idx or -1),
    0-based, negative indices resolved against the current counts."""
    fields = token.split("/")
    v = int(fields[0])
    v = v - 1 if v > 0 else nv + v
    n = -1
    if len(fields) == 3 and fields[2]:
        n = int(fields[2])
        n = n - 1 if n > 0 else nn + n
    return v, n
