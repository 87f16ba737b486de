"""Matrix operations with the book's vocabulary (reference src/matrices.rs).

Counterpart of ``raytracer_tpu/matrices.py`` on torch tensors. The engine
itself uses batched products and inverses; these named helpers
(submatrix/minor/cofactor/determinant/inverse) exist for the library API
and the book-oracle tests. Differentiable; any square size.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.tuples import _t


def identity(n: int = 4):
    return torch.eye(n)


def transpose(m):
    return _t(m).T


def submatrix(m, row: int, col: int):
    """matrices.rs:100-118: drop one row and one column."""
    m = _t(m)
    rows = [i for i in range(m.shape[0]) if i != row]
    cols = [j for j in range(m.shape[1]) if j != col]
    return m[rows][:, cols]


def minor(m, row: int, col: int):
    """matrices.rs:120-126."""
    return determinant(submatrix(m, row, col))


def cofactor(m, row: int, col: int):
    """matrices.rs:128-137: minor with checkerboard sign."""
    sign = -1.0 if (row + col) % 2 else 1.0
    return sign * minor(m, row, col)


def determinant(m):
    """matrices.rs:139-183 (cofactor expansion semantics; computed
    directly for speed and differentiability)."""
    m = _t(m)
    if m.shape[-1] == 1:
        return m[..., 0, 0]
    if m.shape[-1] == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    return torch.linalg.det(m)


def is_invertible(m):
    return bool(determinant(m) != 0.0)


def inverse(m):
    """matrices.rs:185-198 (adjugate inverse semantics)."""
    return torch.linalg.inv(_t(m))


def mat_mul_tuple(m, t):
    """Matrix x 4-tuple (matrices.rs:200-236)."""
    return _t(m) @ _t(t)
