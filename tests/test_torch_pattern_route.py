"""Which calls of a level's pattern stage take ``pattern_color_kernel``
(``ops/patterns_cuda.py``) and which its plain version
(``render.base_color_plain``), and the launch counters that tell them
apart ("pattern" and "pattern_plain" in ``mesh_cuda.launch_counts``).

On the CPU only the plain version runs; the rule's CUDA side is checked
here on stand-ins that carry a CUDA device and ``requires_grad`` flags
(the kernel itself is checked on the card, ``tests/test_torch_cuda.py``).
"""

import types

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import scenes
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import tile_program as TP
from raytracer_tpu_torch.ops import mesh_cuda as MC
from raytracer_tpu_torch.ops import patterns_cuda as PC
from raytracer_tpu_torch.scene import build_scene

GRAD_INPUTS = ("over", "rows", "mat_rows", "pat_a", "pat_b", "pat_inv",
               "uv_wh", "uv_colors", "images")


def _stand_ins(device, grad=()):
    """(scene, over, rows, mat_rows) as objects with a device and a
    requires_grad flag, those named in ``grad`` requiring grad."""
    def t(name):
        return types.SimpleNamespace(device=torch.device(device),
                                     requires_grad=name in grad)
    scene = types.SimpleNamespace(**{k: t(k) for k, _ in PC.TABLES})
    return scene, t("over"), t("rows"), t("mat_rows")


@pytest.mark.parametrize("grad", [(), *((k,) for k in GRAD_INPUTS)],
                         ids=["none", *GRAD_INPUTS])
def test_route_on_cuda(grad):
    """On cuda: the kernel under no_grad whatever requires grad; with grad
    enabled, the kernel only where no input requires grad."""
    args = _stand_ins("cuda", grad)
    with torch.no_grad():
        assert PC.takes_kernel(*args)
    with torch.enable_grad():
        assert PC.takes_kernel(*args) == (not grad)


@pytest.mark.parametrize("grad_mode", [False, True], ids=["no_grad", "grad"])
def test_route_on_cpu_is_plain(grad_mode):
    """A CPU call takes the plain version, with or without grad."""
    with torch.set_grad_enabled(grad_mode):
        assert not PC.takes_kernel(*_stand_ins("cpu"))


def test_kernel_refuses_cpu_tensors():
    items, _ = scenes.every_pattern(8, 8)
    sc = build_scene(items, device="cpu")
    with pytest.raises(ValueError, match="runs on cuda"):
        PC.pattern_base_color(sc, torch.zeros(4, 3), torch.zeros(4, 27),
                              torch.zeros(4, 10))


def test_cpu_render_counts_only_plain():
    """A CPU frame of every pattern kind: one plain evaluation a level
    body run (the program's level log), no kernel launch; and a pattern
    colour on the spheres (the frame is not the material's grey)."""
    items, cam = scenes.every_pattern(24, 16)
    sc = build_scene(items, device="cpu")
    MC.reset_launches()
    img = R.render(sc, cam, quantize=True)
    counts = MC.launch_counts()
    bodies = len(TP.program_of(sc).levels)
    assert bodies > 0
    assert (counts["pattern"], counts["pattern_plain"]) == (0, bodies)
    assert np.unique(img.reshape(-1, 3), axis=0).shape[0] > 20


def test_grad_call_never_counts_the_kernel():
    """A train-style gradient (every float table requires grad) counts
    plain evaluations only."""
    from raytracer_tpu_torch.camera import ray_grid
    from raytracer_tpu_torch.parallel import (partition_scene,
                                              render_loss_and_grad)

    items, cam = scenes.flagship(16, 12)
    sc = build_scene(items, recursion_limit=2, device="cpu")
    o, d = ray_grid(cam, device="cpu")
    params, recombine = partition_scene(sc)
    MC.reset_launches()
    loss, grads = render_loss_and_grad(params, recombine, o, d,
                                       torch.zeros_like(o))
    counts = MC.launch_counts()
    assert counts["pattern"] == 0 and counts["pattern_plain"] > 0
    assert grads["pat_a"].abs().sum() > 0


def test_counters_add_and_reset_through_mesh_cuda():
    """``mesh_cuda`` carries the pattern counters as the programs use
    them: a captured graph's delta added per replay, and reset."""
    MC.reset_launches()
    before = MC.host_counts()
    assert before["pattern"] == before["pattern_plain"] == 0
    MC.add_launches({**{k: 0 for k in before}, "pattern": 3,
                     "pattern_plain": 2}, 2)
    assert (PC.LAUNCHES["pattern"], PC.LAUNCHES["pattern_plain"]) == (6, 4)
    MC.reset_launches()
    assert PC.launch_counts() == {"pattern": 0, "pattern_plain": 0}
