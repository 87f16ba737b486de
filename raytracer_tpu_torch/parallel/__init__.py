"""Training: the differentiable render, its gradients and train steps
(counterpart of ``raytracer_tpu/parallel``; its multi-device modules are
not ported yet)."""

from raytracer_tpu_torch.parallel.train import (
    DERIVED_GEOMETRY,
    make_optim_step,
    partition_scene,
    render_loss,
    render_loss_and_grad,
    train_step,
    with_prim_transform,
)

__all__ = [
    "DERIVED_GEOMETRY",
    "make_optim_step",
    "partition_scene",
    "render_loss",
    "render_loss_and_grad",
    "train_step",
    "with_prim_transform",
]
