"""ctypes bindings for the native host-I/O library (``native/io_native.cpp``).

Counterpart of ``raytracer_tpu/native.py``, with the same entry points:
:func:`parse_obj_arrays`, :func:`ppm_encode_body` and
:func:`ppm_decode_samples`. The source is built with g++ and the flags of
``native/Makefile`` at first use, into the git-ignored ``build/`` beside
the mesh kernel's library (keyed by the source, the flags and the host),
never into ``native/``. Each entry point returns None when the library
cannot be built; its callers then take their pure-Python version of the
same function (:func:`raytracer_tpu_torch.obj._parse_obj_python`, the numpy
PPM codec in :mod:`raytracer_tpu_torch.canvas`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
_SRC = _ROOT / "native" / "io_native.cpp"
_BUILD_DIR = _ROOT / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None
_error = None      # why the library is unavailable, once a build failed


class _ObjCounts(ctypes.Structure):
    _fields_ = [
        ("n_vertices", ctypes.c_int64),
        ("n_normals", ctypes.c_int64),
        ("n_tris", ctypes.c_int64),
        ("n_groups", ctypes.c_int64),
    ]


def build_library() -> Path:
    """Compile ``native/io_native.cpp`` into ``build/`` unless already
    built; returns the library's path. Raises when g++ is missing or
    fails."""
    src = _SRC.read_bytes()
    # -march=native: a build serves only the machine that made it
    key = hashlib.sha1(src + " ".join(CXX_FLAGS + (platform.node(),))
                       .encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"libraytracer_io-{key}.so"
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: it builds native/io_native.cpp")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load():
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build_library()))
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _error = str(e)
                return None
            c_f, c_i64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(
                ctypes.c_int64)
            lib.obj_count.restype = ctypes.c_int
            lib.obj_count.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_ObjCounts)]
            lib.obj_fill.restype = ctypes.c_int
            lib.obj_fill.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, c_f, c_f, c_i64, c_i64, c_i64]
            lib.ppm_encode_ascii.restype = ctypes.c_int64
            lib.ppm_encode_ascii.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_char_p]
            lib.ppm_decode_ascii.restype = ctypes.c_int64
            lib.ppm_decode_ascii.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64]
            _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why :func:`available` is False (the build's error), else None."""
    _load()
    return _error


def parse_obj_arrays(text: str):
    """OBJ text -> (verts [Nv,3] f32, norms [Nn,3] f32, tri_v [Nt,3] i64,
    tri_n [Nt,3] i64 (-1 = flat), tri_group [Nt] i64), or None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    counts = _ObjCounts()
    lib.obj_count(raw, len(raw), ctypes.byref(counts))
    nv, nn, nt = counts.n_vertices, counts.n_normals, counts.n_tris
    verts = np.empty((max(nv, 1), 3), np.float32)
    norms = np.empty((max(nn, 1), 3), np.float32)
    tri_v = np.empty((max(nt, 1), 3), np.int64)
    tri_n = np.empty((max(nt, 1), 3), np.int64)
    tri_g = np.empty(max(nt, 1), np.int64)
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
    lib.obj_fill(raw, len(raw), ptr(verts, ctypes.c_float),
                 ptr(norms, ctypes.c_float), ptr(tri_v, ctypes.c_int64),
                 ptr(tri_n, ctypes.c_int64), ptr(tri_g, ctypes.c_int64))
    return verts[:nv], norms[:nn], tri_v[:nt], tri_n[:nt], tri_g[:nt]


def ppm_encode_body(q: np.ndarray) -> bytes | None:
    """u8 samples -> ASCII P3 body bytes, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(q.reshape(-1), np.uint8)
    buf = ctypes.create_string_buffer(q.size * 4 + 16)
    n = lib.ppm_encode_ascii(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), q.size, buf)
    return buf.raw[:n]


def ppm_decode_samples(body: bytes, max_samples: int) -> np.ndarray | None:
    """ASCII sample text -> u16 array (at most ``max_samples``), or None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(max_samples, np.uint16)
    n = lib.ppm_decode_ascii(
        body, len(body),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), max_samples)
    return out[:n]
