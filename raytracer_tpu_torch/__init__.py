"""raytracer_tpu_torch — the PyTorch/CUDA port of raytracer_tpu.

A Whitted ray tracer over flat SoA scene tables: scenes compile to padded
tensors (``scene.build_scene``), and ``core.render.render`` traces whole
ray batches level by level (trace -> shade -> spawn; deep levels shade
only their live rays). The free-mesh queries run in a hand-written CUDA
kernel for Hopper (``ops/mesh_cuda.py``, ``csrc/mesh_nearest.cu``).

Entry points:

* ``python -m raytracer_tpu_torch --scene x.yaml`` (the CLI) and
  ``scene.yaml_scene.parse_scene``;
* ``core.render.render`` (a frame), ``utils.render_resumable`` (a frame
  flushed tile by tile, resumable) with ``utils.RenderStats`` and
  ``utils.trace_profile``;
* ``parallel``: ``render_loss_and_grad``, ``train_step``,
  ``make_optim_step`` (the differentiable render), and over
  ``torch.distributed`` ``init_distributed``, ``render_sharded`` and
  ``make_sharded_train_step``;
* the book API ``tuples`` and ``matrices``, and ``examples``
  (``basic_scene``, ``csg``, ``hexagon``, ``inverse_render``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package imports torch and numpy only; ``raytracer_tpu`` (JAX) is the
reference it is tested against.
"""

from raytracer_tpu_torch.constants import EPSILON
from raytracer_tpu_torch import transforms
from raytracer_tpu_torch.camera import Camera
from raytracer_tpu_torch.canvas import Canvas

__version__ = "0.1.0"
