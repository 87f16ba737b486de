"""Training and multi-process rendering (counterpart of
``raytracer_tpu/parallel``): the differentiable render, its gradients and
train steps (``train.py``), and the ray axis split over the ranks of a
``torch.distributed`` process group with the scene replicated
(``mesh.py``): frames assembled with one ``all_gather``, gradients summed
with ``all_reduce``."""

from raytracer_tpu_torch.parallel.mesh import (
    init_distributed,
    make_host_mesh,
    make_mesh,
    render_sharded,
    replicate_scene,
    shard_rays,
)
from raytracer_tpu_torch.parallel.train import (
    DERIVED_GEOMETRY,
    make_optim_step,
    make_sharded_train_step,
    partition_scene,
    render_loss,
    render_loss_and_grad,
    train_step,
    with_prim_transform,
)

__all__ = [
    "DERIVED_GEOMETRY",
    "init_distributed",
    "make_host_mesh",
    "make_mesh",
    "make_optim_step",
    "make_sharded_train_step",
    "partition_scene",
    "render_loss",
    "render_loss_and_grad",
    "render_sharded",
    "replicate_scene",
    "shard_rays",
    "train_step",
    "with_prim_transform",
]
