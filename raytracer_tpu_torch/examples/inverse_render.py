"""Inverse rendering: recover a sphere's colour, or its pose, from a target
image by gradient descent through the renderer.

    python -m raytracer_tpu_torch.examples.inverse_render [--pose] [--hd]
        [--device cpu]

Colour mode (default): the scene starts with a blue sphere and plain SGD
on its material row descends the image MSE to the red sphere of the
target, 64x36 (``--hd``: 1280x720, the gradient accumulated over 8
microbatches of 115,200 rays).

``--pose``: the sphere starts at a perturbed translation and
``torch.optim.Adam`` descends the image MSE back to the true position
through ``with_prim_transform`` (the world->object inverse and normal
matrix are recomputed from the pose, so the gradient stays consistent with
the shading). The signal is the local shading and shadow derivative
(silhouette jumps carry none), enough for a small pose error. Coarse to
fine: the pose is found on a 96x54 grid first; ``--hd`` then polishes it
at 1280x720 with a small step.

Counterpart of the JAX package's ``examples/inverse_render.py`` (optax
becomes torch.optim). Runs on ``cuda`` unless ``--device cpu``. Each mode
checks its recovery (colour within 0.05, 0.1 in HD; pose error under 0.05)
and raises ``AssertionError`` when it fails.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.camera import Camera, ray_grid
from raytracer_tpu_torch.core.render import color_at, render
from raytracer_tpu_torch.parallel.train import (
    partition_scene, render_loss_and_grad, with_prim_transform)
from raytracer_tpu_torch.scene import build_scene, specs as S

TRUTH = (0.9, 0.1, 0.1)
TRUE_T = (-0.5, 1.0, 0.5)


def make_scene(color, device):
    return build_scene([
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Plane(material=S.Material(specular=0.0)),
        S.Sphere(transform=tf.translation(*TRUE_T),
                 material=S.Material(color=color, diffuse=0.7)),
    ], recursion_limit=1, device=device)


def camera(hsize, vsize):
    return Camera(hsize, vsize, math.pi / 3).with_transform(
        tf.view_transform((0.0, 1.5, -5.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)))


def target_image(scene, cam, device):
    """The truth, as the flat [n, 3] colours of ray_grid's rays (rendered
    tile by tile, the production forward path)."""
    return torch.as_tensor(render(scene, cam).reshape(-1, 3), device=device)


def recover_color(hd, device, log=print):
    cam = camera(1280, 720) if hd else camera(64, 36)
    n_micro, steps = (8, 60) if hd else (None, 120)
    o, d = ray_grid(cam, device=device)
    target = target_image(make_scene(TRUTH, device), cam, device)
    guess = make_scene((0.1, 0.2, 0.8), device)
    row = int(guess.mat_id[guess.static.family_range("sphere")[0]])
    params, recombine = partition_scene(guess)
    lr, losses = 2.0, []
    for step in range(steps):
        loss, grads = render_loss_and_grad(params, recombine, o, d, target,
                                           n_micro=n_micro)
        losses.append(float(loss))
        # only the sphere's colour is unknown here; the rest of the scene
        # is known (every table descends the same way with an optimizer)
        mat = params["mat"].clone()
        mat[row, :3] -= lr * grads["mat"][row, :3]
        params["mat"] = mat
        if step % (4 if hd else 20) == 0:
            log(f"step {step:3d}  loss {losses[-1]:.6f}  sphere colour "
                f"{params['mat'][row, :3].cpu().numpy().round(3)}")
    final = params["mat"][row, :3].cpu().numpy()
    log(f"recovered colour: {final.round(3)}  (truth: {list(TRUTH)})")
    head = losses[:21]
    if not all(b < a for a, b in zip(head, head[1:])):
        raise AssertionError("loss not strictly decreasing over the first "
                             "20 steps")
    if not losses[-1] < losses[0] * 0.05:
        raise AssertionError(f"loss {losses[0]} -> {losses[-1]}")
    tol = 0.1 if hd else 0.05
    if not np.allclose(final, TRUTH, atol=tol):
        raise AssertionError(f"recovered colour {final}")
    log(f"OK ({cam.hsize}x{cam.vsize}; loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f} over {len(losses)} steps)")
    return dict(color=final.tolist(), losses=losses)


def recover_pose(hd, device, log=print):
    """Coarse to fine: the depth axis has only interior-shading gradients,
    and descending the full-resolution loss directly lets z drift into a
    shallow wrong-depth valley, so the pose is found at 96x54 first."""
    scene = make_scene(TRUTH, device)
    gid = scene.static.family_range("sphere")[0]
    true_t = torch.tensor(TRUE_T, device=device)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=device)
    eye3 = torch.eye(3, device=device)

    def stage_loss(rays, target, micro):
        o, d = rays

        def loss_fn(t3):
            m = torch.cat([torch.cat([eye3, t3[:, None]], 1), bottom])
            sc = with_prim_transform(scene, gid, m)
            chunks = micro or 1
            m_rays = o.shape[0] // chunks
            total = 0.0
            for i in range(chunks):     # gradient accumulation (HD memory)
                sl = slice(i * m_rays, (i + 1) * m_rays)
                img = color_at(sc, o[sl], d[sl])
                part = torch.mean((img - target[sl]) ** 2) / chunks
                part.backward()
                total += float(part.detach())
            return total

        return loss_fn

    def descend(loss_fn, t3, lr, n_steps, tag, every):
        t3 = t3.clone().requires_grad_(True)
        opt = torch.optim.Adam([t3], lr=lr)
        losses = []
        for step in range(n_steps):
            opt.zero_grad(set_to_none=True)
            losses.append(loss_fn(t3))
            opt.step()
            if step % every == 0:
                err = float(torch.linalg.norm(t3.detach() - true_t))
                log(f"{tag} step {step:3d}  loss {losses[-1]:.6f}  pos "
                    f"{t3.detach().cpu().numpy().round(3)}  err {err:.4f}")
        return t3.detach(), losses

    c_cam = camera(96, 54)
    c_rays = ray_grid(c_cam, device=device)
    c_target = target_image(scene, c_cam, device)
    t3 = true_t + torch.tensor([0.2, -0.12, 0.1], device=device)
    t3, losses = descend(stage_loss(c_rays, c_target, None), t3, 2e-2, 200,
                         "coarse", 25)
    cam = c_cam
    if hd:
        # a small step: Adam's update is about lr whatever the gradient's
        # scale, so polishing from the coarse optimum with a large one
        # random-walks away from it
        cam = camera(1280, 720)
        f_rays = ray_grid(cam, device=device)
        t3, f_losses = descend(
            stage_loss(f_rays, target_image(scene, cam, device), 8), t3,
            3e-4, 30, "fine", 8)
        losses += f_losses
    err = float(torch.linalg.norm(t3 - true_t))
    log(f"recovered translation: {t3.cpu().numpy().round(4)}  (truth "
        f"{list(TRUE_T)})  error {err:.4f}")
    if not err < 0.05:
        raise AssertionError(f"pose error {err}")
    if not losses[-1] < losses[0] * 0.1:
        raise AssertionError(f"loss {losses[0]} -> {losses[-1]}")
    third = len(losses) // 3
    if not np.mean(losses[-third:]) < np.mean(losses[:third]):
        raise AssertionError("the loss curve does not trend down")
    log(f"OK pose ({cam.hsize}x{cam.vsize}; loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} over {len(losses)} steps)")
    return dict(translation=t3.cpu().numpy().tolist(), error=err,
                losses=losses)


def main(argv=None, log=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pose", action="store_true",
                    help="recover the sphere's translation, not its colour")
    ap.add_argument("--hd", action="store_true", help="1280x720")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if args.pose:
        return recover_pose(args.hd, device, log)
    return recover_color(args.hd, device, log)


if __name__ == "__main__":
    main()
