"""Camera: batched ray generation.

Counterpart of ``raytracer_tpu/camera.py``. Semantics follow the reference
camera (camera.rs:18-64): half_width/half_height derived from fov and
aspect, rays shot through pixel centers on the z=-1 canvas through the
inverse camera transform. :func:`ray_grid` produces the whole pixel grid
of rays as tensors; the renderer generates its rays per tile on the device
(``core.render.tile_rays``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from raytracer_tpu_torch import transforms


@dataclass
class Camera:
    hsize: int
    vsize: int
    field_of_view: float
    transform: np.ndarray = field(default_factory=transforms.identity)

    def __post_init__(self):
        half_view = math.tan(self.field_of_view / 2.0)
        aspect = self.hsize / self.vsize
        if aspect >= 1.0:
            self.half_width = half_view
            self.half_height = half_view / aspect
        else:
            self.half_width = half_view * aspect
            self.half_height = half_view
        self.pixel_size = (self.half_width * 2.0) / self.hsize

    def with_transform(self, transform) -> "Camera":
        if isinstance(transform, transforms.Transform):
            transform = transform.matrix
        return Camera(self.hsize, self.vsize, self.field_of_view,
                      np.asarray(transform, np.float32))


def ray_grid(camera: Camera, device="cuda"):
    """All primary rays for the camera, flattened in row-major (py, px) order.

    Returns ``(origins, directions)`` f32 tensors of shape
    ``[vsize*hsize, 3]`` on ``device``; pixel (px, py) is at flat index
    ``py * hsize + px``. Computed in numpy exactly as
    ``raytracer_tpu.camera.ray_grid`` does.
    """
    inv = np.linalg.inv(camera.transform).astype(np.float32)

    px = np.arange(camera.hsize, dtype=np.float32)
    py = np.arange(camera.vsize, dtype=np.float32)
    # Offsets from canvas edge to pixel centers (camera.rs:45-52).
    world_x = camera.half_width - (px + 0.5) * camera.pixel_size
    world_y = camera.half_height - (py + 0.5) * camera.pixel_size

    wx, wy = np.meshgrid(world_x, world_y)      # [vsize, hsize]
    n = camera.vsize * camera.hsize
    pixels_h = np.stack(
        [wx.ravel(), wy.ravel(), np.full(n, -1.0, np.float32),
         np.ones(n, np.float32)],
        axis=-1,
    )                                           # [n, 4] points on z=-1 canvas
    pixel_world = pixels_h @ inv.T              # [n, 4]
    origin_world = inv @ np.array([0.0, 0.0, 0.0, 1.0], np.float32)

    origins = np.broadcast_to(origin_world[:3], (n, 3))
    directions = pixel_world[:, :3] - origin_world[:3]
    directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    as_t = lambda x: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(x, np.float32), device=device)
    return as_t(origins), as_t(directions)


def ray_for_pixel(camera: Camera, px: int, py: int):
    """Single-ray reference helper (camera.rs:45-64) for tests: the
    (origin, direction) of pixel (px, py), numpy f32 [3] each, as
    :func:`ray_grid` makes them (``raytracer_tpu.camera.ray_for_pixel``)."""
    origins, directions = ray_grid(camera, device="cpu")
    idx = py * camera.hsize + px
    return origins[idx].numpy(), directions[idx].numpy()


def _mat4_rows(a, b):
    """a [n, 4] x b [4, 4]^T (rows of a through b), as sums of elementwise
    products: no matmul, so no TF32 path rounds the camera."""
    return (a[:, 0:1] * b[:, 0] + a[:, 1:2] * b[:, 1] + a[:, 2:3] * b[:, 2]
            + a[:, 3:4] * b[:, 3])


def view_transform_tensor(from_p, to_p, up):
    """Differentiable view_transform (transformations.rs:122-134) over f32
    tensors, the counterpart of the JAX package's ``view_transform_jax``:
    gradients flow to the eye, the target and the up vector. -> [4, 4]."""
    from_p, to_p, up = (torch.as_tensor(x, dtype=torch.float32)
                        for x in (from_p, to_p, up))
    to_p, up = to_p.to(from_p.device), up.to(from_p.device)

    def norm(v):
        return v / torch.clamp_min(torch.sqrt((v * v).sum()), 1e-12)

    forward = norm(to_p - from_p)
    left = torch.linalg.cross(forward, norm(up))
    true_up = torch.linalg.cross(left, forward)
    zero = forward.new_zeros(1)
    orientation = torch.stack([
        torch.cat([left, zero]), torch.cat([true_up, zero]),
        torch.cat([-forward, zero]), forward.new_tensor([0.0, 0.0, 0.0, 1.0]),
    ])
    trans = torch.cat([
        torch.cat([torch.eye(3, device=from_p.device), -from_p[:, None]], 1),
        forward.new_tensor([[0.0, 0.0, 0.0, 1.0]]),
    ])
    return _mat4_rows(orientation, trans.T)


def ray_grid_tensor(cam_inv, hsize: int, vsize: int, field_of_view):
    """Differentiable whole-grid ray generation (camera.rs:45-64), the
    counterpart of the JAX package's ``ray_grid_jax``.

    ``cam_inv``: the INVERSE camera matrix [4, 4] (e.g.
    ``torch.linalg.inv(view_transform_tensor(...))``). Returns (origins
    [n, 3], directions [n, 3]) in row-major (py, px) order on
    ``cam_inv``'s device; gradients flow to ``cam_inv`` and
    ``field_of_view``."""
    dev = cam_inv.device
    fov = torch.as_tensor(field_of_view, dtype=torch.float32, device=dev)
    half_view = torch.tan(fov / 2.0)
    aspect = hsize / vsize
    half_width = half_view if aspect >= 1.0 else half_view * aspect
    half_height = half_view / aspect if aspect >= 1.0 else half_view
    pixel_size = half_width * 2.0 / hsize

    px = torch.arange(hsize, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(vsize, dtype=torch.float32, device=dev) + 0.5
    world_x = half_width - px * pixel_size
    world_y = half_height - py * pixel_size
    wy, wx = torch.meshgrid(world_y, world_x, indexing="ij")
    n = hsize * vsize
    pixels_h = torch.stack([wx.reshape(-1), wy.reshape(-1),
                            torch.full((n,), -1.0, device=dev),
                            torch.ones(n, device=dev)], -1)
    pixel_world = _mat4_rows(pixels_h, cam_inv)
    origin_world = cam_inv[:, 3]               # cam_inv @ (0, 0, 0, 1)
    directions = pixel_world[:, :3] - origin_world[:3]
    directions = directions / torch.clamp_min(
        torch.sqrt((directions * directions).sum(-1, keepdim=True)), 1e-12)
    origins = origin_world[:3].expand(n, 3)
    return origins, directions
