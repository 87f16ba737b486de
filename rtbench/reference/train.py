"""The reference's training runs: plain autograd through ``tracer``.

``sgd_run`` fits the scene's float tables (``Scene.params``) to the frame
of another description by SGD; ``adam_pose_run`` fits the camera's eye by
``torch.optim.Adam``. Both take the image MSE over every ray of a
``hsize`` x ``vsize`` grid, summed in blocks of rays whose gradients add
(the loss is a mean over rays, so the blocks' order does not matter)."""

from __future__ import annotations

import torch

from rtbench.reference import tracer

BLOCK = 32768


def _blocks(cam, device):
    n = int(cam["hsize"]) * int(cam["vsize"])
    return torch.arange(n, device=device).split(BLOCK), n


def frame_colors(sc, cam, eye=None):
    """The colours [hsize * vsize, 3] of every ray of ``cam`` (row-major),
    without gradients."""
    blocks, _ = _blocks(cam, sc.device)
    with torch.no_grad():
        return torch.cat([tracer.trace(sc, *tracer.camera_rays(
            cam, device=sc.device, dtype=sc.dtype, eye=eye, pixels=b))
            for b in blocks])


def _loss_backward(sc, cam, target, eye=None):
    """The image MSE against ``target``, its gradients accumulated into
    the leaves that ``sc`` reads (and ``eye``), block by block."""
    blocks, n = _blocks(cam, sc.device)
    total = torch.zeros((), dtype=torch.float64, device=sc.device)
    for b in blocks:
        o, d = tracer.camera_rays(cam, device=sc.device, dtype=sc.dtype,
                                  eye=eye, pixels=b)
        img = tracer.trace(sc, o, d)
        loss = ((img - target[b]) ** 2).sum() / (n * 3)
        loss.backward()
        total += loss.detach().double()
    return float(total)


def sgd_run(true_desc, start_desc, cam, *, lr, steps, device,
            dtype=torch.float32):
    """SGD from ``start_desc``'s tables against ``true_desc``'s frame.
    Returns (the loss of each step, the tables before the first step and
    after each step)."""
    target = frame_colors(tracer.Scene(true_desc, device=device,
                                       dtype=dtype), cam)
    sc0 = tracer.Scene(start_desc, device=device, dtype=dtype)
    params = {k: v.detach().clone() for k, v in sc0.params.items()}
    hist, losses = [params], []
    for _ in range(steps):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        losses.append(_loss_backward(sc0.with_params(leaves), cam, target))
        with torch.no_grad():
            params = {k: v - lr * (torch.zeros_like(v) if v.grad is None
                                   else v.grad)
                      for k, v in leaves.items()}
        hist.append(params)
    return losses, hist


def adam_pose_run(desc, cam, eye0, *, lr, steps, device, dtype=torch.float32):
    """Adam on the eye from ``eye0`` against the frame from ``cam``'s own
    eye. Returns (the loss of each step, the eye before the first step and
    after each step, Adam's first moment after the first and after the
    last step)."""
    sc = tracer.Scene(desc, device=device, dtype=dtype)
    target = frame_colors(sc, cam)
    eye = torch.tensor(eye0, dtype=dtype, device=device, requires_grad=True)
    opt = torch.optim.Adam([eye], lr=lr)
    hist, losses, moments = [eye.detach().clone()], [], []
    for s in range(steps):
        opt.zero_grad(set_to_none=True)
        losses.append(_loss_backward(sc, cam, target, eye=eye))
        opt.step()
        if s in (0, steps - 1):
            moments.append(opt.state[eye]["exp_avg"].detach().clone())
        hist.append(eye.detach().clone())
    return losses, hist, moments
