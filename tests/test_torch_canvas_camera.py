"""Canvas and ray generation of raytracer_tpu_torch against the JAX
package: PPM bytes identical, the same primary rays, the same 16x16
block order of pixels."""

import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu import canvas as JCV
from raytracer_tpu.core import render as JR
from raytracer_tpu_torch import canvas as CV
from raytracer_tpu_torch import scenes
from raytracer_tpu_torch.camera import ray_grid
from raytracer_tpu_torch.core import render as R
from torch_port_helpers import jax_camera


def _image(h=7, w=11, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32)
    img[0, 0] = (0.5 / 255, 1.5 / 255, 254.5 / 255)  # round-half cases
    return img


@pytest.mark.parametrize("shape", [(7, 11), (1, 5), (3, 5)])
def test_ppm_bytes_identical(shape):
    img = _image(*shape)
    assert CV.to_ppm_bytes(img) == JCV.to_ppm_bytes(img)
    # a u8 frame (render(quantize=True)) writes the same bytes
    assert CV.to_ppm_bytes(CV.quantize_u8(img)) == JCV.to_ppm_bytes(img)
    a, b = io.BytesIO(), io.BytesIO()
    CV.Canvas(shape[1], shape[0], img).to_ppm(a)
    JCV.Canvas(shape[1], shape[0], img).to_ppm(b)
    assert a.getvalue() == b.getvalue()


def test_ppm_decode_and_p6_roundtrip():
    img = _image()
    data = JCV.to_ppm_bytes(img)
    np.testing.assert_array_equal(CV.from_ppm_bytes(data),
                                  JCV.from_ppm_bytes(data))
    p6 = CV.to_p6_bytes(img)
    np.testing.assert_array_equal(CV.from_ppm_bytes(p6),
                                  JCV.from_ppm_bytes(p6))
    np.testing.assert_array_equal(
        np.round(CV.from_ppm_bytes(p6) * 255).astype(np.uint8),
        CV.quantize_u8(img))


@pytest.mark.parametrize("n,colored", [(2, False), (4, True), (8, False)])
def test_dithering_matches_jax(n, colored):
    img = _image(9, 13, seed=n)
    a = CV.Canvas(13, 9, img)
    b = JCV.Canvas(13, 9, img)
    a.apply_dithering(n, colored)
    b.apply_dithering(n, colored)
    np.testing.assert_array_equal(a.pixels, b.pixels)
    np.testing.assert_array_equal(CV.bayer_matrix(n), JCV.bayer_matrix(n))


def test_device_quantize_is_quantize_u8():
    """render(quantize=True)'s formula on tensors = canvas.quantize_u8."""
    x = np.concatenate([_image(16, 16).reshape(-1),
                        (np.arange(256, dtype=np.float32) + 0.5) / 255])
    t = torch.as_tensor(x)
    q = torch.floor(t.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    np.testing.assert_array_equal(q.numpy(), CV.quantize_u8(x))
    np.testing.assert_array_equal(q.numpy(), JCV.quantize_u8(x))


def test_ray_grid_matches_jax():
    from raytracer_tpu.camera import ray_grid as jax_ray_grid

    _, cam = scenes.dragons_equiv(1, hsize=40, vsize=16)
    o, d = ray_grid(cam, device="cpu")
    jo, jd = jax_ray_grid(jax_camera(cam))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_tile_rays_match_jax():
    """Per-tile primary rays on the device: the same pixel ids give the
    same rays as the JAX package's tile_rays, bit for bit (the camera
    product and the norm round as XLA rounds them op by op;
    tests/test_torch_tile_program.py holds 32 cameras)."""
    _, cam = scenes.flagship(64, 48)
    inv, consts = R.camera_consts(cam, "cpu")
    jinv, jconsts = JR.camera_consts(jax_camera(cam))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(consts.numpy(), np.asarray(jconsts))
    idx = np.arange(64 * 48)
    o, d = R.tile_rays(inv, consts, torch.as_tensor(idx), 64)
    jo, jd = JR.tile_rays(jinv, jconsts, jnp.asarray(idx, jnp.int32), 64)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    # and agree with the whole-grid generator
    _, dg = ray_grid(cam, device="cpu")
    np.testing.assert_allclose(d.numpy(), dg.numpy(), atol=1e-6)


@pytest.mark.parametrize("h,w", [(48, 64), (50, 37), (480, 1200)])
def test_block_order_matches_jax(h, w):
    order = R._block_order(h, w, 16)
    np.testing.assert_array_equal(order, JR._block_order(h, w, 16))
    # built once per (h, w, block) and shared read-only
    assert R._block_order(h, w, 16) is order
    assert not order.flags.writeable
    with pytest.raises(ValueError):
        order[0] = 1
    assert np.array_equal(np.sort(order), np.arange(h * w))
    if h % 16 == 0 and w % 16 == 0:
        # every 256 consecutive ids are one 16x16 pixel block
        blocks = order.reshape(-1, 256)
        ys, xs = blocks // w, blocks % w
        assert ((ys.max(1) - ys.min(1)) == 15).all()
        assert ((xs.max(1) - xs.min(1)) == 15).all()
    order2, tiles = R._order_tiles(h, w, 1024, "cpu")
    np.testing.assert_array_equal(order2, order)
    assert tiles.shape[1] == 1024
    np.testing.assert_array_equal(tiles.reshape(-1)[: h * w].numpy(), order)


@pytest.mark.parametrize("hsize,vsize", [(16, 8), (9, 14)])
def test_tensor_camera_matches_jax_and_ray_grid(hsize, vsize):
    """view_transform_tensor + ray_grid_tensor against the JAX package's
    view_transform_jax + ray_grid_jax (the same function, 1e-6) and the
    numpy ray_grid (1e-5); the gradient reaches the eye, the target and
    the field of view."""
    from raytracer_tpu.camera import ray_grid_jax, view_transform_jax
    from raytracer_tpu_torch import transforms as tf
    from raytracer_tpu_torch.camera import (
        Camera, ray_grid_tensor, view_transform_tensor)

    eye, to, up, fov = (0.3, 1.5, -5.0), (0.0, 1.0, 0.2), (0.0, 1.0, 0.0), 1.1
    frm = torch.tensor(eye, requires_grad=True)
    at = torch.tensor(to, requires_grad=True)
    fov_t = torch.tensor(fov, requires_grad=True)
    vt = view_transform_tensor(frm, at, up)
    o, d = ray_grid_tensor(torch.linalg.inv(vt), hsize, vsize, fov_t)
    j_vt = view_transform_jax(jnp.asarray(eye), jnp.asarray(to),
                              jnp.asarray(up))
    j_o, j_d = ray_grid_jax(jnp.linalg.inv(j_vt), hsize, vsize, fov)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(j_vt),
                               atol=1e-6)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(j_o), atol=1e-6)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(j_d), atol=1e-6)
    cam = Camera(hsize, vsize, fov).with_transform(
        tf.view_transform(eye, to, up))
    n_o, n_d = ray_grid(cam, device="cpu")
    np.testing.assert_allclose(o.detach().numpy(), n_o.numpy(), atol=1e-5)
    np.testing.assert_allclose(d.detach().numpy(), n_d.numpy(), atol=1e-5)
    (o.sum() + (d * torch.linspace(0, 1, d.numel()).reshape(d.shape)).sum()
     ).backward()
    for g in (frm.grad, at.grad, fov_t.grad):
        assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
