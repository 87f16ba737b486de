"""4x4 affine transforms in float64 (transformations.rs): the op lists of
the scene files, composed as the Rust code composes them (each op applied
after the ones before it)."""

from __future__ import annotations

import math

import numpy as np


def translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def scale(x, y, z):
    return np.diag([x, y, z, 1.0])


def rotate_x(r):
    c, s = math.cos(r), math.sin(r)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0],
                     [0, 0, 0, 1.0]])


def rotate_y(r):
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                     [0, 0, 0, 1.0]])


def rotate_z(r):
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1.0]])


OPS = {"translate": translate, "scale": scale, "rotate-x": rotate_x,
       "rotate-y": rotate_y, "rotate-z": rotate_z}


def compose(ops):
    """The matrix of an op list such as [["translate", 0, 2, 0],
    ["scale", 0.5, 0.5, 0.5]]: later ops multiply from the left."""
    m = np.eye(4)
    for op, *args in ops or []:
        m = OPS[op](*args) @ m
    return m


def num(x) -> str:
    """A number as the scene files' YAML reads it: decimal, never in
    exponent form."""
    x = float(x)
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return np.format_float_positional(x, trim="-")


def yaml_ops(ops) -> str:
    """An op list in the YAML's flow form."""
    return "[" + ", ".join(
        "[" + ", ".join([op] + [num(a) for a in args]) + "]"
        for op, *args in ops) + "]"
