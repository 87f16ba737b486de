"""The port's packed level against the JAX package's at the two widths
that tests/test_torch_packed.py leaves out, R/16 and R/2 (a file of its own
because the JAX side, run op by op, compiles every op once per width)."""

import pytest

from test_torch_packed import N_RAYS, check_level_vs_jax, items
from torch_port_helpers import same_tables


@pytest.fixture(scope="module")
def scenes_():
    return same_tables(items(mesh=False), jitter=(0.5,), recursion_limit=3)


@pytest.mark.parametrize("jax_thread_perm", [False, True])
@pytest.mark.parametrize("n_live,width", [(200, N_RAYS // 16),
                                          (1600, N_RAYS // 2)])
def test_packed_level_matches_jax(scenes_, n_live, width, jax_thread_perm):
    check_level_vs_jax(*scenes_, n_live, width, jax_thread_perm)
