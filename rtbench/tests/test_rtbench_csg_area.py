"""The csg_area.frame cell at a CPU size, in a copy of the benchmark with
its own cut of the csg_area configuration: it runs through the harness
and comes out correct against the CSG and area-light reference, and its
traced run reports the area-light count; the program with either planted
fault of ``control_area.py`` and the reference in bfloat16 fail its
limits. And the readers of ``area_rays.frame``, ``area_ms.frame`` and
``csg_ms.frame`` on synthetic spans and marks: nothing without the count
or the marks (as with a program that has neither), without device time,
or in a train cell."""

import json
from types import SimpleNamespace

import pytest
import torch

from rtbench.control_area import planted
from rtbench.harness import cell, common
from rtbench.loops import area_frame as A
from rtbench.tests.tiny import edit_json, tiny_tree

SEED = 2 ** 32 + 11
# one tile of 3,456 rays: the solid fills the middle of the frame
FRAME = (72, 48)
# the faults' frame: at 72x48 an 8 x 8 block averages the one-sample
# fault's hard shadow edges and highlights over too large a patch of the
# solid to show them (block_gap 3.0 there, 18.4 at 160x90, 75 at 640x360)
FAULT_FRAME = (160, 90)
METRICS = common.BENCH_DIR / "metrics"


def cut_tree(tmp, frame):
    root = tiny_tree(tmp)
    b = root / "rtbench"

    def cut(cfg):
        cfg["camera"]["hsize"], cfg["camera"]["vsize"] = frame
    edit_json(b / "configs" / "csg_area.json", cut)

    def frames(tr):
        tr["warmup"], tr["profile_units"] = 1, 1
    edit_json(b / "traffic" / "area_frame.json", frames)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cut_tree(tmp_path_factory.mktemp("tiny"), FRAME)


@pytest.fixture(scope="module")
def fault_root(tmp_path_factory):
    return cut_tree(tmp_path_factory.mktemp("faults"), FAULT_FRAME)


@pytest.fixture(scope="module", autouse=True)
def _spans():
    """The readers' helper: importing it turns the program's span
    recorder on, which is turned off and emptied again once this module's
    tests are done."""
    from rtbench.metrics import _spans

    yield _spans
    if _spans.RECORDER is not None:
        _spans.RECORDER.disable()
        _spans.RECORDER.clear()


def run(root, traced=False):
    return json.loads(cell.execute("csg_area.frame", SEED, 0.2, traced,
                                   t0=0.0, root=root,
                                   device=torch.device("cpu")))


def limits():
    return common.load_json(common.BENCH_DIR / "checks"
                            / "csg_area.frame.json")


def test_the_cell_runs_and_is_correct(root):
    out = run(root)
    assert out["correct"]
    assert set(out["metrics"]) == {"frame_s", "peak_mem_GiB", "setup_s"}
    assert set(out["checks"]) == {"px_off_hard", "block_gap"}
    traced = run(root, traced=True)
    assert traced["correct"]
    got = traced["metrics"]
    # one tile of 3,456 rays, 100 samples each
    assert got["area_rays.frame"]["value"] == pytest.approx(0.3456)
    assert got["shaded_rows.frame"]["value"] == pytest.approx(0.003456)
    # no device time on the CPU: the marks' readers give nothing
    assert "area_ms.frame" not in got and "csg_ms.frame" not in got


@pytest.mark.parametrize("fault, number", [("csg_union", "px_off_hard"),
                                           ("one_sample", "block_gap")])
def test_each_fault_fails_its_number(fault_root, fault, number):
    with planted(fault):
        out = run(fault_root)
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_the_control_fails():
    cfg = common.load_json(common.BENCH_DIR / "configs" / "csg_area.json")
    cfg["camera"]["hsize"], cfg["camera"]["vsize"] = FRAME
    mod = common.load_module(common.BENCH_DIR / "configs" / "csg_area.py")
    desc = mod.describe(cfg, SEED)
    cpu = torch.device("cpu")
    want = A.reference_frame(desc, SEED, cpu)
    band = A.noise_band(desc, cpu)
    low = A.reference_frame(desc, SEED + 1, cpu, torch.bfloat16)
    lim = limits()
    assert A.px_off_hard(low, want, band) > lim["px_off_hard"] \
        or A.block_gap(low, want) > lim["block_gap"]


def test_block_means_and_the_shapes():
    img = torch.arange(10 * 12 * 3, dtype=torch.uint8).reshape(
        10, 12, 3).numpy()
    means = A.block_means(img)
    assert means.shape == (2, 2, 3)
    assert means[1, 1, 0] == pytest.approx(img[8:, 8:, 0].mean())
    assert A.block_gap(img, img) == 0.0
    assert A.block_gap(img, img[:8]) == 255.0
    band = img[..., 0] < 0
    assert A.px_off_hard(img, img[:8], band) == 1.0


def reader(name):
    return common.load_module(METRICS / f"{name}.py")


def span(name, sid, parent=None, profiled=False, **attrs):
    return SimpleNamespace(name=name, sid=sid, parent=parent,
                           rid=sid if parent is None else parent, start=0,
                           end=1, profiled=profiled, attrs=attrs)


def test_area_rays_of_the_unprofiled_frames(monkeypatch, _spans):
    rays = reader("area_rays.frame")
    monkeypatch.setattr(_spans, "spans", lambda: [
        span("frame", 1, area_rays=23_347_200, rows_shaded=233_472),
        span("frame", 2, area_rays=23_347_200),
        span("frame", 3, profiled=True, area_rays=1),
        span("step", 4, area_rays=5)])
    assert rays.read(dict(kind="frame")) == pytest.approx(23.3472)
    assert rays.read(dict(kind="train")) is None
    # the parent's program: no count
    monkeypatch.setattr(_spans, "spans", lambda: [
        span("frame", 1, rows_shaded=233_472)])
    assert rays.read(dict(kind="frame")) is None


def marked(**marks):
    return dict(kind="frame", marks=marks)


def test_the_marks_readers():
    area, csg = reader("area_ms.frame"), reader("csg_ms.frame")
    lay = marked(frame=dict(us=9000.0, count=1),
                 area_light=dict(us=6000.0, count=57),
                 csg_filter=dict(us=2500.0, count=114))
    assert area.read(lay) == pytest.approx(6.0)
    assert csg.read(lay) == pytest.approx(2.5)
    # a program without the marks, the CPU (no device time), no marked
    # frame, a train cell
    for lay in (marked(frame=dict(us=9000.0, count=1)),
                marked(frame=dict(us=0.0, count=1),
                       area_light=dict(us=0.0, count=57)),
                dict(kind="frame"), dict(kind="train", marks=None)):
        assert area.read(lay) is None and csg.read(lay) is None
