"""The differential fuzz through raytracer_tpu_torch: the random
full-feature scenes of the JAX package's benchmarks/fuzz_differential.py
(CSG trees on odd seeds, a 3x3 area light on seeds divisible by 3, two
6,320-triangle mesh instances on even seeds, transparent on seeds
divisible by 4), drawn by the port's own generator
(``scenes.random_scene``) and held against the JAX package.

* The port's generator gives the JAX generator's tables, exactly.
* The port's u8 frames (on the CPU) agree with the JAX package's stored
  images (tests/data/torch_fuzz_jax_u8.npz, written by
  tests/torch_fuzz_goldens.py): seeds 1 to 30 at 64x48, and the ten
  area-light seeds at 64x64, where the packed deep levels run.

Budget: at most 0.5% of a frame's pixels more than one u8 step apart, as
fuzz_differential.py:194 held the JAX package's TPU lowering against its
CPU lowering.

The slow case renders every seed live through JAX (about 15 to 80 s a
seed: each is its own XLA program); tier-1 deselects it.
"""

import gc
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu_torch import scenes
from raytracer_tpu_torch.core import render as R
from torch_port_helpers import (
    assert_same_tables, fuzz_differential, jax_fuzz_rays, jax_random_scene)

GOLDENS = Path(__file__).resolve().parent / "data" / "torch_fuzz_jax_u8.npz"
SEEDS = range(1, 31)
AREA_SEEDS = range(3, 31, 3)
BUDGET = 0.005       # share of pixels more than one u8 step apart


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs. The fuzz's frames are
    thousands of small ops; six test processes at torch's default thread
    count oversubscribe the cores, and then each op waits on threads that
    do not run, which slows these frames by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as z:
        return {k: z[k] for k in z.files}


def over_one_step(a, b):
    """Share of pixels of two u8 frames more than one step apart."""
    return float((np.abs(a.astype(int) - b.astype(int)).max(-1) > 1).mean())


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_matches_jax(seed):
    """scenes.random_scene(seed) == fuzz_differential.random_scene(seed):
    every table and static fact (and on mesh seeds the mesh kernel's packed
    planes too; the JAX builder packs only 1024+ free triangles)."""
    assert_same_tables(jax_random_scene(seed),
                       scenes.random_scene(seed, device="cpu"),
                       skip_mesh=seed % 2 == 1)


@pytest.mark.parametrize("seed,hsize,vsize",
                         [(s, 64, 48) for s in SEEDS]
                         + [(s, 64, 64) for s in AREA_SEEDS])
def test_frame_matches_jax(goldens, monkeypatch, seed, hsize, vsize):
    """The port's frame on the CPU against the stored JAX image. A 64x64
    frame is one 4,096-ray tile of an area-light scene: every level past
    the first runs packed (seed 15 has none: no ray of its frame survives
    the first level)."""
    widths, real_step = [], R.shade_step

    def step_spy(*a, **kw):
        widths.append(kw["width"])
        return real_step(*a, **kw)

    monkeypatch.setattr(R, "shade_step", step_spy)
    img = R.render(scenes.random_scene(seed, device="cpu"),
                   scenes.fuzz_camera(hsize, vsize), quantize=True)
    want = goldens[f"s{seed}_{hsize}x{vsize}"]
    assert img.shape == want.shape == (vsize, hsize, 3)
    assert over_one_step(img, want) <= BUDGET
    if vsize == 64:
        assert widths[0] is None and None not in widths[1:]
        assert len(widths) > 1 or seed == 15


def test_goldens_record_their_versions(goldens):
    assert goldens["jax_version"].dtype.kind == "U"
    assert goldens["numpy_version"].dtype.kind == "U"
    assert len(goldens) == 2 + len(SEEDS) + len(AREA_SEEDS)


@pytest.mark.slow
@pytest.mark.parametrize("seed", SEEDS)
def test_goldens_are_jax_all_seeds(goldens, seed):
    """Every stored 64x48 image against a live fuzz_differential
    render_local on this machine (a CPU of another instruction set may
    round a few pixels a step apart: the budget, not equality)."""
    o, d = jax_fuzz_rays()
    got = fuzz_differential().render_local(jax_random_scene(seed), o, d)
    jax.clear_caches()
    gc.collect()
    assert over_one_step(got.reshape(48, 64, 3),
                         goldens[f"s{seed}_64x48"]) <= BUDGET
    with torch.no_grad():
        port = R.render(scenes.random_scene(seed, device="cpu"),
                        scenes.fuzz_camera(), quantize=True)
    assert over_one_step(port, got.reshape(48, 64, 3)) <= BUDGET
