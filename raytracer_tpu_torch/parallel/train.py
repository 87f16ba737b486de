"""Differentiable rendering: loss, gradients and training steps.

Counterpart of ``raytracer_tpu/parallel/train.py``. The whole level loop of
:func:`~raytracer_tpu_torch.core.render.color_at` is differentiable torch,
so scene parameters (material tables, light intensities, pattern colours,
transforms ...) can be optimized against a target image. The free-mesh
query reaches its gradient through
:class:`~raytracer_tpu_torch.ops.mesh_cuda.MeshNearest`: the mesh kernel
(or its plain version on the CPU) forward, a recompute of the winning
triangle's Moller-Trumbore backward.

Parameters are dicts of tensors named after the :class:`Scene` fields
(:func:`partition_scene`); gradients come back as dicts of the same keys.
The JAX package's ``make_optax_step`` becomes :func:`make_optim_step` over
``torch.optim``; its sharded step is :func:`make_sharded_train_step`, over
``torch.distributed`` (``parallel/mesh.py``).

The JAX package jits its train steps; here every entry point that takes
a gradient runs it through ``core/train_program.TrainProgram`` by default
(``graphs=True``): on the card a microbatch is one forward and one
backward CUDA graph launch, its levels skipped or packed by conditional
nodes, and a step reads the card once, at its end; on the CPU the same
steps run on the same buffers without capture. ``graphs=False`` runs
:func:`render_loss` eagerly and backpropagates through autograd, every op
launched from the host.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.core.render import color_at, full_f32
from raytracer_tpu_torch.parallel.mesh import _layout

# Float tables DERIVED from (or coupled to) other tables at scene build:
# inv_tf pairs with normal_mat, the triangle rows with their precomputed
# world-space normals, pat_inv is the inverse of the pattern transform,
# alight_pos comes from corner/uvec/vvec, and the mesh kernel's packed
# tables copy the triangle rows. Optimizing one without its partners
# desyncs geometry from shading, so they stay out of the default grad
# surface (opt in with include_geometry=True and keep them consistent).
DERIVED_GEOMETRY = frozenset({
    "inv_tf", "normal_mat",
    "tri_p1", "tri_e1", "tri_e2",
    "tri_shade", "tri_det_eps",
    "pat_inv",
    "alight_corner", "alight_uvec", "alight_vvec", "alight_pos",
    "mesh_planes", "mesh_bb_chunk", "mesh_bb_super",
})


def partition_scene(scene: T.Scene, *, include_geometry: bool = False):
    """Split the scene into ``(params, recombine)``.

    ``params``: the float tensors of the scene, by field name, outside
    :data:`DERIVED_GEOMETRY` unless ``include_geometry``. Integer and bool
    tables stay fixed. ``recombine(params)`` -> a :class:`Scene` with those
    tensors in place of the originals."""
    params, rest = {}, {}
    for name in T.ARRAY_FIELDS:
        val = getattr(scene, name)
        if (isinstance(val, torch.Tensor) and val.is_floating_point()
                and (include_geometry or name not in DERIVED_GEOMETRY)):
            params[name] = val
        else:
            rest[name] = val

    def recombine(p):
        return T.Scene(**p, **rest, static=scene.static)

    return params, recombine


def render_loss(params, recombine, origins, directions, target,
                generator=None, *, remat=True):
    """Mean squared error between the rendered ray colours and ``target``
    [R, 3]. ``generator``: the area-light jitter's (see ``color_at``).
    Every training entry point renders through here, and so runs with
    TF32 off (``full_f32``).

    ``remat=True`` (default) recomputes each bounce level in the backward
    pass instead of keeping its intermediates (``color_at``): a blend
    scene's deepest level is 16x the ray batch wide."""
    full_f32()
    img = color_at(recombine(params), origins, directions,
                   generator=generator, remat=remat)
    return torch.mean((img - target) ** 2)


def _leaves(params):
    """Fresh leaf tensors holding the parameters' values."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _grads(leaves, scale=1.0):
    """The leaves' accumulated ``.grad`` (zeros where none reached them,
    as ``jax.grad`` gives), times ``scale``."""
    return {k: (torch.zeros_like(v) if v.grad is None else v.grad * scale)
            for k, v in leaves.items()}


def _grad_microbatched(params, recombine, origins, directions, target,
                       generator, n_micro, remat=True):
    """(loss, grads) of :func:`render_loss`, accumulated over ``n_micro``
    equal sequential chunks of the ray axis, so the backward pass holds one
    chunk at a time. Exact: the MSE over equal chunks averages to the full
    batch's, and gradients are linear in the loss."""
    n = origins.shape[0]
    if n % n_micro:
        raise ValueError(f"batch {n} not divisible by {n_micro} microbatches")
    m = n // n_micro
    leaves = _leaves(params)
    loss_sum = torch.zeros((), device=origins.device)
    ray_grad = origins.requires_grad or directions.requires_grad
    for i in range(n_micro):
        sl = slice(i * m, (i + 1) * m)
        loss = render_loss(leaves, recombine, origins[sl], directions[sl],
                           target[sl], generator, remat=remat)
        # rays that require grad share what made them across microbatches
        loss.backward(retain_graph=ray_grad and i < n_micro - 1)
        loss_sum = loss_sum + loss.detach()
    scale = 1.0 / n_micro
    return loss_sum * scale, _grads(leaves, scale)


def render_loss_and_grad(params, recombine, origins, directions, target,
                         generator=None, *, n_micro=None, remat=True,
                         graphs=True):
    """(loss, grads) of :func:`render_loss` with respect to ``params``: the
    entry point of custom optimization loops. ``n_micro`` accumulates the
    gradient over that many sequential ray microbatches (exact; it bounds
    the backward pass's memory by one microbatch). ``remat``: per-level
    recompute (see :func:`render_loss`); with enough microbatches to fit
    memory, ``remat=False`` saves the recompute. Where the origins or the
    directions require grad, the backward goes on into them (and so into
    what made them, e.g. a camera's pose), once per microbatch;
    ``params`` may then be empty.

    ``graphs=True`` runs each microbatch through a
    :class:`~raytracer_tpu_torch.core.train_program.TrainProgram`: on cuda,
    one forward and one backward CUDA graph launch, the levels skipped or
    packed on the card (captured at first use, found again on later
    steps), and one read of the card at the step's end; on the CPU, the
    same steps on the same buffers without capture. ``graphs=False``
    runs the eager :func:`render_loss` and ``backward()``, every op
    launched from the host. Both give the same loss and gradients (bit
    for bit on the CPU; on cuda the gradients to rounding, see the
    program's docstring)."""
    if graphs:
        loss, grads = _graphed_loss_and_grad(
            params, recombine, origins, directions, target, generator,
            n_micro or 1, remat)
        return loss, {k: torch.zeros_like(params[k]) if g is None else g
                      for k, g in grads.items()}
    if n_micro is not None and n_micro > 1:
        return _grad_microbatched(params, recombine, origins, directions,
                                  target, generator, n_micro, remat=remat)
    leaves = _leaves(params)
    loss = render_loss(leaves, recombine, origins, directions, target,
                       generator, remat=remat)
    loss.backward()
    return loss.detach(), _grads(leaves)


def _graphed_loss_and_grad(params, recombine, origins, directions, target,
                           generator, n_micro, remat):
    """:func:`render_loss_and_grad` through the train program, with the
    eager path's arithmetic: per-microbatch losses summed and gradients
    added in order, then scaled by ``1 / n_micro``. The microbatches are
    enqueued without a read of the card; the step's one read, at its end,
    brings the level logs and with them which tables the render reached
    (a table it never reaches gets None, as an eager leaf's ``.grad``). A
    microbatch's sum of a table it does not reach is -0.0, which adds
    nothing, so the first microbatch that reaches a table gives its sum
    bit for bit, as eager's first ``.grad`` is that microbatch's."""
    from raytracer_tpu_torch.core.train_program import program_for

    full_f32()
    n = origins.shape[0]
    if n % n_micro:
        raise ValueError(f"batch {n} not divisible by {n_micro} microbatches")
    m = n // n_micro
    rays = (origins, directions)
    ray_grad = tuple(x.requires_grad for x in rays)
    prog = program_for(params, recombine, m, remat=remat, ray_grad=ray_grad)
    prog.load(params)
    loss_sum = torch.zeros((), device=origins.device)
    total = {}
    for i in range(n_micro):
        sl = slice(i * m, (i + 1) * m)
        loss = prog.forward(origins[sl], directions[sl], target[sl],
                            generator)
        grads, g_rays = prog.backward()
        if any(ray_grad):
            # the camera's graph, outside the program, eagerly
            torch.autograd.backward(
                [x[sl] for x, need in zip(rays, ray_grad) if need],
                [g for g, need in zip(g_rays, ray_grad) if need],
                retain_graph=i < n_micro - 1)
        loss_sum = loss_sum + loss
        for k, g in grads.items():
            total[k] = g.clone() if k not in total else total[k].add_(g)
    reached = prog.settle()
    scale = 1.0 if n_micro == 1 else 1.0 / n_micro
    out = {k: total[k] * scale if k in reached else None for k in params}
    return (loss.clone() if n_micro == 1 else loss_sum * scale), out


def train_step(scene: T.Scene, origins, directions, target, *, lr=1e-2,
               generator=None, n_micro=None, remat=True, graphs=True):
    """One SGD step on every float table of :func:`partition_scene`.
    Returns (loss, the updated scene). ``n_micro``, ``remat``, ``graphs``:
    see :func:`render_loss_and_grad`; the update runs eagerly."""
    params, recombine = partition_scene(scene)
    loss, grads = render_loss_and_grad(
        params, recombine, origins, directions, target, generator,
        n_micro=n_micro, remat=remat, graphs=graphs)
    return loss, recombine(_sgd(params, grads, lr))


def _sgd(params, grads, lr):
    """The SGD update ``p - lr * g`` of every parameter."""
    with torch.no_grad():
        return {k: p - lr * grads[k] for k, p in params.items()}


def make_optim_step(optimizer_factory, *, param_filter=None, graphs=True):
    """A training step over the scene's float tables with a
    ``torch.optim`` optimizer (the JAX package's ``make_optax_step``).

    ``optimizer_factory(list_of_tensors)`` -> an optimizer, e.g.
    ``torch.optim.Adam`` or ``functools.partial(torch.optim.Adam,
    lr=1e-2)``. ``param_filter``: optional predicate ``name -> bool``
    choosing the tables to optimize (the others stay fixed). Returns
    ``(init_fn(scene) -> opt_state, step_fn(scene, opt_state, origins,
    directions, target, generator=None) -> (loss, scene', opt_state'))``.
    ``opt_state`` holds the optimizer and its parameter tensors; a step
    first loads the values of the scene it is given into them.

    The render runs with ``remat=True``; ``graphs``: see
    :func:`render_loss_and_grad`. With ``graphs=True`` the gradient comes
    from the train program, which copies the parameter tensors' values
    into its own buffers, and the optimizer's step runs eagerly after it
    (a table the render never reaches keeps ``.grad`` None, as in the
    eager step)."""
    def split(scene):
        params, recombine = partition_scene(scene)
        keep = param_filter or (lambda _: True)
        train = {k: v for k, v in params.items() if keep(k)}
        frozen = {k: v for k, v in params.items() if not keep(k)}
        return train, frozen, recombine

    def init_fn(scene):
        train, _, _ = split(scene)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in train.items()}
        return optimizer_factory(list(leaves.values())), leaves

    def step_fn(scene, opt_state, origins, directions, target,
                generator=None):
        opt, leaves = opt_state
        train, frozen, recombine = split(scene)
        with torch.no_grad():
            for k, v in train.items():
                leaves[k].copy_(v)
        opt.zero_grad(set_to_none=True)
        if graphs:
            loss, grads = _graphed_loss_and_grad(
                leaves, lambda p: recombine({**p, **frozen}), origins,
                directions, target, generator, 1, True)
            for k, v in leaves.items():
                v.grad = grads[k]
        else:
            loss = render_loss({**leaves, **frozen}, recombine, origins,
                               directions, target, generator)
            loss.backward()
            loss = loss.detach()
        opt.step()
        new = {k: v.detach().clone() for k, v in leaves.items()}
        return loss, recombine({**new, **frozen}), opt_state

    return init_fn, step_fn


def make_sharded_train_step(mesh=None, *, lr=1e-2, n_micro=None,
                            remat=True, graphs=True):
    """A train step over a ray batch split across ranks, the parameters
    replicated (the counterpart of the JAX package's sharded step).

    The returned ``step(scene, origins, directions, target, generator=None)
    -> (loss, scene')`` takes this rank's shard of the batch. Each rank
    computes :func:`render_loss_and_grad` on its shard (``n_micro``
    sequential microbatches of it; ``remat`` and ``graphs`` as there), then
    one ``all_reduce`` per mesh dimension (the ranks of a host first, then
    the hosts; over float64) sums the loss and gradients weighted by the
    shards'
    ray counts, so loss and gradients are those of the concatenated global
    batch, on every rank, and every rank applies the same SGD update.
    ``mesh``: a mesh of :mod:`~raytracer_tpu_torch.parallel.mesh` (None: the
    default group; one process alone: :func:`train_step`'s numbers)."""
    _, _, groups = _layout(mesh)

    def step(scene, origins, directions, target, generator=None):
        params, recombine = partition_scene(scene)
        loss, grads = render_loss_and_grad(
            params, recombine, origins, directions, target, generator,
            n_micro=n_micro, remat=remat, graphs=graphs)
        keys = sorted(grads)
        n = float(origins.shape[0])
        flat = torch.cat([torch.stack([loss.double() * n,
                                       loss.new_tensor(n).double()])]
                         + [grads[k].reshape(-1).double() * n for k in keys])
        for g in groups:
            torch.distributed.all_reduce(flat, group=g)
        total = flat[1]
        loss = (flat[0] / total).float()
        off = 2
        for k in keys:
            size = grads[k].numel()
            grads[k] = (flat[off:off + size] / total).float().reshape(
                grads[k].shape)
            off += size
        return loss, recombine(_sgd(params, grads, lr))

    return step


def with_prim_transform(scene: T.Scene, gid: int, matrix):
    """The scene with primitive ``gid``'s world transform replaced,
    differentiably: its world->object inverse and normal matrix are
    recomputed from ``matrix`` [4, 4] (``torch.linalg.inv``), so a gradient
    with respect to the matrix (or a pose that makes it) keeps them
    consistent. The rows are replaced out of place.

    Non-triangle primitives only: a mesh's vertices are baked into world
    space at build, so reposing one needs a rebuild (``ValueError``).
    ``gid`` is the primitive's global id, e.g.
    ``scene.static.family_range("sphere")[0]``."""
    full_f32()
    g_nt = sum(scene.static.counts[:5])
    if not 0 <= gid < g_nt:
        raise ValueError(
            f"gid {gid} is not a non-triangle primitive (0..{g_nt - 1})")
    matrix = torch.as_tensor(matrix, dtype=torch.float32,
                             device=scene.device)
    inv = torch.linalg.inv(matrix)
    row = torch.tensor([gid], device=scene.device)
    return dataclasses.replace(
        scene,
        inv_tf=scene.inv_tf.index_put((row,), inv[None]),
        normal_mat=scene.normal_mat.index_put((row,), inv.T[None, :3, :3]),
    )
