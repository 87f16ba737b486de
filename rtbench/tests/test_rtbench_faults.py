"""Each fault that a cell can have, planted under the timed path of a run
at a CPU size, makes ``correct`` come out false; the unbroken run of the
same cell comes out true. The faults: an answer altered where it is
produced (a frame's block of pixels), half of the batch left out (half of
a frame's rows; a train step or a pose step over half of its rays, the
mean over the rest), and a step that returns its state unchanged."""

import json

import numpy as np
import pytest
import torch

from rtbench.control import half_batch_grad, half_batch_step
from rtbench.harness import cell
from rtbench.tests.tiny import tiny_tree

SEED = 2 ** 32 + 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))


def run(root, workload):
    return json.loads(cell.execute(workload, SEED, 0.2, False, t0=0.0,
                                   root=root, device=torch.device("cpu")))


def altered(frame):
    out = frame.copy()
    out[2:6, 2:6] = 255 - out[2:6, 2:6]
    return out


def half_rows(frame):
    out = frame.copy()
    out[frame.shape[0] // 2:] = 0
    return out


@pytest.mark.parametrize("workload", ["dragons.frame", "flagship.frame"])
@pytest.mark.parametrize("fault", [None, altered, half_rows])
def test_frame_faults(root, workload, fault, monkeypatch):
    from raytracer_tpu_torch.core import render as R

    if fault is not None:
        orig = R.render
        monkeypatch.setattr(R, "render",
                            lambda *a, **k: fault(orig(*a, **k)))
    assert run(root, workload)["correct"] == (fault is None)


def unchanged_step(orig):
    def step(scene, o, d, target, **kw):
        loss, _ = orig(scene, o, d, target, **kw)
        return loss, scene
    return step


@pytest.mark.parametrize("fault", [None, unchanged_step, half_batch_step])
def test_train_faults(root, fault, monkeypatch):
    import raytracer_tpu_torch.parallel as P

    if fault is not None:
        monkeypatch.setattr(P, "train_step", fault(P.train_step))
    assert run(root, "flagship.train")["correct"] == (fault is None)


def no_gradient(orig):
    # the rays' gradient stops at rays cut off from the eye: Adam leaves
    # the eye as it is
    def grad(params, recombine, o, d, target, **kw):
        return orig(params, recombine, o.detach().requires_grad_(True),
                    d.detach().requires_grad_(True), target, **kw)
    return grad


@pytest.mark.parametrize("fault", [None, no_gradient, half_batch_grad])
def test_pose_faults(root, fault, monkeypatch):
    import raytracer_tpu_torch.parallel as P

    if fault is not None:
        monkeypatch.setattr(P, "render_loss_and_grad",
                            fault(P.render_loss_and_grad))
    traffic = root / "rtbench" / "traffic" / "pose.json"
    tr = json.loads(traffic.read_text())
    tr["rays"] = [128, 64]
    traffic.write_text(json.dumps(tr))
    assert run(root, "dragons.pose")["correct"] == (fault is None)


def test_the_frame_fault_helpers():
    f = np.full((8, 8, 3), 10, np.uint8)
    assert (altered(f)[2, 2] == 245).all() and (half_rows(f)[7] == 0).all()
