"""``core/intersect.table_gather`` of raytracer_tpu_torch against the JAX
package's ``intersect.table_gather``, on the CPU (its plain version:
``table[idx]`` forward, an ``index_add_`` backward in index order).

The same numpy inputs from a seed go through both, for every route of the
JAX function (masked reduce at G <= 32, one-hot product up to 1024, gather
beyond: G in 1, 5, 32, 33, 1024, 1025), table shapes [G], [G, 3] and
[G, 4, 4] of f32, int32 and bool, and indices [R] and [R, S]:

* the forward equal exactly;
* for f32 tables, the gradient of ``sum(w * out)``, ``jax.grad`` against
  torch autograd, to rtol 1e-4 (the sums add in another order);
* two plain backwards bit-equal.

Then one ``render.shade_level`` on a five-primitive scene (patterns, a
glass blend sphere, a cube), whose table gradients, transforms and
normal matrices among them (they reach the shading through one
``table_gather`` of their concatenation), equal JAX's to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import intersect as JI
from raytracer_tpu.core import render as JR
from raytracer_tpu.parallel.train import partition_scene as jax_partition
from raytracer_tpu_torch import scenes
from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.core import intersect as I
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.ops import gather_cuda as GA
from raytracer_tpu_torch.parallel import partition_scene
from raytracer_tpu_torch.scene import specs as S
from torch_port_helpers import assert_grads_match, same_tables, unit_rays

DTYPES = {"f32": (np.float32, torch.float32), "i32": (np.int32, torch.int32),
          "bool": (np.bool_, torch.bool)}


def table_of(rng, g, rest, dtype):
    shape = (g, *rest)
    if dtype == "f32":
        return rng.normal(size=shape).astype(np.float32)
    if dtype == "i32":
        return rng.integers(-1000, 1000, size=shape).astype(np.int32)
    return rng.random(shape) < 0.5


@pytest.mark.parametrize("idx_shape", [(257,), (64, 5)], ids=["R", "RxS"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rest", [(), (3,), (4, 4)], ids=["G", "Gx3", "Gx4x4"])
@pytest.mark.parametrize("g", [1, 5, 32, 33, 1024, 1025])
def test_table_gather_matches_jax(g, rest, dtype, idx_shape):
    rng = np.random.default_rng(g * 31 + len(rest) * 7 + len(idx_shape))
    table = table_of(rng, g, rest, dtype)
    idx = rng.integers(0, g, size=idx_shape).astype(np.int32)
    check_against_jax(rng, table, idx, dtype, torch.int64, torch.int32)


# the lookups of the train cells, as (G, K) of the table, its type and the
# indices' (chip_smoke 7b records them): flagship_train's material rows
# (int64 indices, as the port's gids), the shading rows of five and of
# glass_train's 57 primitives, a flag column and one-column tables
CELL_CALLS = {"G4_K10_i64": (4, (10,), "f32", torch.int64),
              "G5_K27": (5, (27,), "f32", torch.int32),
              "G57_K27": (57, (27,), "f32", torch.int64),
              "bool": (57, (), "bool", torch.int64),
              "K1": (1, (), "f32", torch.int64),
              "K1_i32_table": (4, (), "i32", torch.int32)}


@pytest.mark.parametrize("case", list(CELL_CALLS))
def test_table_gather_cells_match_jax(case):
    """test_table_gather_matches_jax's checks at the shapes of the train
    cells' lookups (CELL_CALLS), 4,099 indices."""
    g, rest, dtype, idx_dtype = CELL_CALLS[case]
    rng = np.random.default_rng(len(case) * 13 + g)
    table = table_of(rng, g, rest, dtype)
    idx = rng.integers(0, g, size=(4099,)).astype(np.int32)
    check_against_jax(rng, table, idx, dtype, idx_dtype, idx_dtype)


def check_against_jax(rng, table, idx, dtype, idx_dtype, grad_idx_dtype):
    """The port's table_gather of ``table`` at ``idx`` (as ``idx_dtype``)
    against JAX's: the forward exactly; for an f32 table the gradient of
    ``sum(w * out)`` (indices as ``grad_idx_dtype``) to rtol 1e-4 and two
    backwards bit-equal."""
    want = np.asarray(jax.jit(JI.table_gather)(jnp.asarray(table),
                                               jnp.asarray(idx)))
    t_table = torch.from_numpy(table)
    got = I.table_gather(t_table, torch.from_numpy(idx).to(idx_dtype))
    assert got.dtype == DTYPES[dtype][1]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype != "f32":
        return
    w = rng.normal(size=want.shape).astype(np.float32)
    j_grad = jax.jit(jax.grad(lambda t: jnp.sum(
        jnp.asarray(w) * JI.table_gather(t, jnp.asarray(idx)))))(
            jnp.asarray(table))
    grads = []
    for _ in range(2):
        leaf = t_table.clone().requires_grad_(True)
        (torch.from_numpy(w) * I.table_gather(
            leaf, torch.from_numpy(idx).to(grad_idx_dtype))).sum().backward()
        grads.append(leaf.grad)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(j_grad),
                               rtol=1e-4, atol=1e-6)
    assert grads[0].numpy().tobytes() == grads[1].numpy().tobytes()


def test_plain_backward_is_index_order_and_clamps():
    """The plain backward adds each row's contributions in index order
    (bit for bit a sequential f32 sum), and out-of-range indices read and
    receive at the clamped row, as the kernel does."""
    rng = np.random.default_rng(0)
    g, n = 4, 5000
    idx = rng.integers(-2, g + 2, size=n)
    grad = rng.normal(size=(n, 3)).astype(np.float32)
    want = np.zeros((g, 3), np.float32)
    for i, r in enumerate(np.clip(idx, 0, g - 1)):
        want[r] += grad[i]
    got = GA.gather_backward_plain(torch.from_numpy(grad),
                                   torch.from_numpy(idx), g)
    assert got.numpy().tobytes() == want.tobytes()
    table = torch.arange(g * 3, dtype=torch.float32).reshape(g, 3)
    np.testing.assert_array_equal(
        GA.gather_forward_plain(table, torch.from_numpy(idx)).numpy(),
        table.numpy()[np.clip(idx, 0, g - 1)])


def five_primitives():
    """The flagship's floor and spheres and a striped cube: five
    primitives, two patterns, a reflective and transparent blend."""
    items, _ = scenes.flagship(16, 8)
    cube = S.Cube(
        transform=tf.Transform().scaling(0.4, 0.4, 0.4)
        .translation(0.6, 0.4, -1.2).matrix,
        material=S.Material(color=(0.3, 0.6, 0.9), reflective=0.2,
                            pattern=S.Pattern("striped", a=(0.9, 0.2, 0.2),
                                              b=(0.2, 0.9, 0.2))))
    return items + [cube]


def test_shade_level_table_gradients_match_jax():
    js, ps = same_tables(five_primitives())
    assert sum(ps.static.counts) == 5
    rng = np.random.default_rng(3)
    o, d = unit_rays(rng, 128, center=(0.0, 1.5, -5.0), spread=0.3,
                     aim=(0.0, -0.25, 1.0), jitter=0.25)
    weight = rng.uniform(0.5, 1.0, (128, 3)).astype(np.float32)
    cots = [rng.normal(size=(128, 3)).astype(np.float32) for _ in range(5)]

    def loss_of(outs, dot):
        surface, (_, reflectv, w_refl), (_, refr_dir, w_refr) = outs
        return sum(dot(c, x) for c, x in zip(
            cots, (surface, reflectv, w_refl, refr_dir, w_refr)))

    jp, jr = jax_partition(js, include_geometry=True)
    # op by op, not jitted: jit rounds a few values differently (ROADMAP F5)
    j_grads = jax.grad(lambda p: loss_of(
        JR.shade_level(jr(p), jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(weight), None),
        lambda c, x: jnp.sum(jnp.asarray(c) * x)))(jp)
    params, recombine = partition_scene(ps, include_geometry=True)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss_of(R.shade_level(recombine(leaves), torch.from_numpy(o),
                          torch.from_numpy(d), torch.from_numpy(weight)),
            lambda c, x: (torch.from_numpy(c) * x).sum()).backward()
    grads = {k: torch.zeros_like(v) if v.grad is None else v.grad
             for k, v in leaves.items()}
    assert set(grads) == set(j_grads)
    assert_grads_match(grads, j_grads)
    for k in ("mat", "inv_tf", "normal_mat", "pat_a", "pat_b"):
        assert float(np.abs(np.asarray(j_grads[k])).sum()) > 0, k
