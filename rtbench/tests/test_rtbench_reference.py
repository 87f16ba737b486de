"""The plain reference against the program on the CPU, at tiny frames
and batches: both configurations' frames, a flagship training run and a
dragons pose run (the dragon cut to 768 triangles). Also the book's own value
of one shaded ray, which the reference reaches without the program."""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench.harness import common, xf
from rtbench.loops import frame as frame_loop
from rtbench.loops import pose as pose_loop
from rtbench.loops import train as train_loop
from rtbench.reference import tracer
from rtbench.tests import tiny

CONFIGS = common.BENCH_DIR / "configs"
SEED = 2 ** 31 + 77


def config(name, size):
    cfg = common.load_json(CONFIGS / f"{name}.json")
    cfg["camera"]["hsize"], cfg["camera"]["vsize"] = size
    tiny.cut_mesh(cfg)
    return cfg, common.load_module(CONFIGS / f"{name}.py")


def test_the_books_default_world():
    # world.rs's default world; a ray from (0, 0, -5) along +z shades to
    # (0.38066, 0.47583, 0.2855) (the book, ch. 7)
    desc = dict(
        camera={}, lights=[dict(position=(-10, 10, -10))],
        materials=[tracer.material(color=(0.8, 1.0, 0.6), diffuse=0.7,
                                   specular=0.2), tracer.material()],
        shapes=[dict(kind="sphere", transform=np.eye(4), material=0),
                dict(kind="sphere", transform=xf.scale(0.5, 0.5, 0.5),
                     material=1)])
    sc = tracer.Scene(desc)
    c = tracer.trace(sc, torch.tensor([[0.0, 0.0, -5.0]]),
                     torch.tensor([[0.0, 0.0, 1.0]]))
    assert c[0].tolist() == pytest.approx([0.38066, 0.47583, 0.2855],
                                          abs=1e-4)


@pytest.mark.parametrize("name, size", [("flagship", (96, 54)),
                                        ("dragons", (120, 48))])
def test_frames_agree(name, size, tmp_path):
    from raytracer_tpu_torch.core.render import render

    cfg, mod = config(name, size)
    desc = mod.describe(cfg, SEED)
    cam, scene = mod.port_scene(cfg, desc, tmp_path, "cpu")
    got = render(scene, cam, quantize=True)
    want = tracer.render_u8(tracer.Scene(desc))
    assert frame_loop.px_off(got, want) <= 0.01


def run_cell(loop, name, traffic, rays):
    cfg, mod = config(name, tuple(rays))
    tr = common.load_json(common.BENCH_DIR / "traffic" / f"{traffic}.json")
    tr["rays"] = list(rays)
    with tempfile.TemporaryDirectory() as work:
        cell = loop.Cell(cfg, mod, tr, SEED, Path(work), torch.device("cpu"))
        cell.setup()
    return cell


def test_training_agrees():
    cell = run_cell(train_loop, "flagship", "train", (32, 16))
    nums = cell.numbers(*cell.reference_run())
    assert cell.grad_leaves and cell.change_leaves
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-3 and nums["change_gap"] < 1e-3
    assert nums["stray_change"] == 0.0


def test_pose_agrees():
    cell = run_cell(pose_loop, "dragons", "pose", (128, 64))
    nums = cell.numbers(*cell.reference_run())
    assert nums["loss_gap"] < 0.02
    assert nums["grad_gap"] < 0.02 and nums["moment_gap"] < 0.02


def test_the_configurations_are_json():
    for name in ("dragons", "flagship"):
        cfg = json.loads((CONFIGS / f"{name}.json").read_text())
        assert cfg["name"] == name and cfg["reduced"] == []
