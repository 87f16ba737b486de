"""The glass.frame cell at a CPU size, in a copy of the benchmark with its
own cut of the glass configuration: it runs through the harness and comes
out correct against the walk reference; the reference in bfloat16 and the
program with the "no behind column" fault (``control_walk.py``) fail its
limit. And the reader of ``k1_behind_share.frame`` on synthetic
profiles: nothing without the counter by mode (as with a program that
counts K1's tests in one slot), without tests, or in a train cell."""

import json

import pytest
import torch

from rtbench.control_walk import planted
from rtbench.harness import cell, common
from rtbench.loops.frame import px_off
from rtbench.reference import walk
from rtbench.tests.tiny import cut_mesh, edit_json, tiny_tree

SEED = 2 ** 32 + 9
# 18 instances (two rows of the grid) at 96x54: the fault shows on the
# meshes behind the first row
FRAME, INSTANCES = (96, 54), 18


def cut(cfg):
    cfg["camera"]["hsize"], cfg["camera"]["vsize"] = FRAME
    cfg["instances"]["count"] = INSTANCES
    cut_mesh(cfg)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_tree(tmp_path_factory.mktemp("tiny"))
    b = root / "rtbench"
    edit_json(b / "configs" / "glass.json", cut)

    def frames(tr):
        tr["warmup"], tr["profile_units"] = 1, 1
    edit_json(b / "traffic" / "walk_frame.json", frames)
    return root


def run(root, traced=False):
    return json.loads(cell.execute("glass.frame", SEED, 0.2, traced, t0=0.0,
                                   root=root, device=torch.device("cpu")))


def test_the_cell_runs_and_is_correct(root):
    out = run(root)
    assert out["correct"]
    assert set(out["metrics"]) == {"frame_s", "peak_mem_GiB", "setup_s"}
    traced = run(root, traced=True)
    assert traced["correct"]
    # no counter on the CPU: K1's tests are counted on the card
    assert "k1_behind_share.frame" not in traced["metrics"]
    assert "capture_s" in traced["metrics"]


def test_the_fault_fails(root):
    with planted("no_behind"):
        assert not run(root)["correct"]


def test_the_control_fails(root):
    cfg = common.load_json(root / "rtbench" / "configs" / "glass.json")
    mod = common.load_module(root / "rtbench" / "configs" / "glass.py")
    desc = mod.describe(cfg, SEED)
    want = walk.render_u8(walk.Scene(desc))
    low = walk.render_u8(walk.Scene(desc, dtype=torch.bfloat16))
    limit = common.load_json(common.BENCH_DIR / "checks"
                             / "glass.frame.json")["px_off"]
    assert not common.check(px_off(low, want), limit)["ok"]


def reader():
    return common.load_module(common.BENCH_DIR / "metrics"
                              / "k1_behind_share.frame.py")


def layer(kind="frame", **counters):
    return dict(kind=kind, unit_s=0.3, profile=dict(
        units=3, wall_s=1.0, kernels={}, counters=counters))


def test_behind_share_of_the_profiled_frames():
    lay = layer(k1_tests=400, k1_tests_nearest=250, k1_tests_any_hit=50,
                k1_tests_behind=100)
    assert reader().read(lay) == pytest.approx(25.0)
    assert reader().read(layer(k1_tests=400, k1_tests_behind=0)) == 0.0


def test_behind_share_is_nothing_without_the_counters():
    # the parent's program: one slot, no count by mode
    assert reader().read(layer(k1_tests=400)) is None
    assert reader().read(layer(k1_tests=0, k1_tests_behind=0)) is None
    assert reader().read(layer()) is None
    assert reader().read(layer("train", k1_tests=400,
                               k1_tests_behind=100)) is None
    assert reader().read(dict(kind="frame", unit_s=0.3, profile=None)) is None
