"""The control: the reference put in the program's place and computed in
bfloat16, the precision below the float32 that the configurations state.
Held against the float32 reference at a CPU size, it fails each cell's
limits (rtbench/checks/), as it does at the cells' own sizes on the card
(``python3 rtbench/control.py``)."""

import numpy as np
import pytest
import torch

from rtbench.harness import common, compare
from rtbench.loops import frame as frame_loop
from rtbench.reference import tracer
from rtbench.reference import train as ref_train
from rtbench.tests import tiny

CHECKS = common.BENCH_DIR / "checks"
CONFIGS = common.BENCH_DIR / "configs"
SEED = 12


def described(name, size):
    cfg = common.load_json(CONFIGS / f"{name}.json")
    cfg["camera"]["hsize"], cfg["camera"]["vsize"] = size
    tiny.cut_mesh(cfg)
    mod = common.load_module(CONFIGS / f"{name}.py")
    return cfg, mod, mod.describe(cfg, SEED)


def failed(nums, limits):
    return [k for k, v in nums.items()
            if not common.check(v, limits[k])["ok"]]


@pytest.mark.parametrize("name, size", [("flagship", (96, 54)),
                                        ("dragons", (120, 48))])
def test_frame_control_fails(name, size):
    _, _, desc = described(name, size)
    want = tracer.render_u8(tracer.Scene(desc))
    low = tracer.render_u8(tracer.Scene(desc, dtype=torch.bfloat16))
    limits = common.load_json(CHECKS / f"{name}.frame.json")
    assert failed({"px_off": frame_loop.px_off(low, want)}, limits)


def test_train_control_fails():
    cfg, mod, desc = described("flagship", (32, 16))
    start = mod.train_start(cfg, desc, SEED)
    runs = [ref_train.sgd_run(desc, start, desc["camera"], lr=1e-3, steps=3,
                              device="cpu", dtype=dt)
            for dt in (torch.float32, torch.bfloat16)]
    (l32, h32), (l16, h16) = [
        (losses, [{k: v.float().numpy() for k, v in h.items()}
                  for h in hist]) for losses, hist in runs]
    nums, _, _ = compare.sgd_numbers(h16, h32, l16, l32, 1e-3)
    assert failed(nums, common.load_json(CHECKS / "flagship.train.json"))


def test_pose_control_fails():
    cfg, mod, desc = described("dragons", (64, 32))
    cam = desc["camera"]
    eye0 = (np.asarray(cam["from"]) + [0.05, -0.05, 0.05]).astype(np.float32)
    runs = [ref_train.adam_pose_run(desc, cam, eye0, lr=0.03, steps=3,
                                    device="cpu", dtype=dt)
            for dt in (torch.float32, torch.bfloat16)]
    (l32, m32), (l16, m16) = [
        (losses, [m.float().numpy() for m in moments])
        for losses, _, moments in runs]
    nums = compare.adam_numbers(l16, l32, m16, m32)
    assert failed(nums, common.load_json(CHECKS / "dragons.pose.json"))
