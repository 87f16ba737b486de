"""Named tuple/point/vector/color operations (reference src/tuples.rs).

Counterpart of ``raytracer_tpu/tuples.py`` on torch tensors. The SoA
engine works on bare ``[..., 3]`` tensors; these helpers give the book's
vocabulary (point/vector constructors with the w component,
magnitude/normalize/dot/cross/reflect, colour blending and u8 conversion)
for library users and tests. They take tensors, numpy arrays or sequences,
keep a tensor's device, and are differentiable (the constructors too, when
given tensors).
"""

from __future__ import annotations

import torch

WHITE = (1.0, 1.0, 1.0)
BLACK = (0.0, 0.0, 0.0)


def _t(x):
    """``x`` as a float tensor (a float tensor is returned as it is)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32)


def _stack(*xs):
    """The components stacked, on the device of the tensors among them."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return torch.stack([_t(x).to(dev) for x in xs])


def point(x, y, z):
    """w=1 homogeneous point (tuples.rs:115)."""
    return _stack(x, y, z, 1.0)


def vector(x, y, z):
    """w=0 homogeneous vector (tuples.rs:209)."""
    return _stack(x, y, z, 0.0)


def color(r, g, b):
    return _stack(r, g, b)


def is_point(t):
    return bool(t[3] == 1.0)


def is_vector(t):
    return bool(t[3] == 0.0)


def magnitude(v):
    """tuples.rs:232-236."""
    return torch.linalg.vector_norm(_t(v)[..., :3], dim=-1)


def normalize(v):
    """tuples.rs:238-241 (w preserved for 4-vectors)."""
    v = _t(v)
    n = torch.clamp_min(magnitude(v), 1e-12)
    if v.shape[-1] == 4:
        return torch.cat([v[..., :3] / n[..., None], v[..., 3:]], -1)
    return v / n[..., None]


def dot(a, b):
    """tuples.rs:243-245."""
    return (_t(a)[..., :3] * _t(b)[..., :3]).sum(-1)


def cross(a, b):
    """tuples.rs:247-249 (3-component result)."""
    return torch.linalg.cross(_t(a)[..., :3], _t(b)[..., :3])


def reflect(v, n):
    """tuples.rs:250-254: v - 2*dot(v,n)*n."""
    v3 = _t(v)[..., :3]
    n3 = _t(n)[..., :3]
    return v3 - 2.0 * dot(v3, n3)[..., None] * n3


def hadamard(c1, c2):
    """Colour blend (tuples.rs Color * Color)."""
    return _t(c1) * _t(c2)


def to_u8(c):
    """Clamped round-to-u8 channel conversion (tuples.rs:367-377)."""
    c = torch.clamp(_t(c), 0.0, 1.0)
    return torch.floor(c * 255.0 + 0.5).to(torch.uint8)
