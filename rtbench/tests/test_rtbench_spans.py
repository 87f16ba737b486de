"""The readers of the program's spans and on-card counters on synthetic
input: the median per root, the profiled roots left out, the spans of
other roots and kinds ignored, nothing where the spans or the counters
are absent (as with a program that records none), and the rooflines on
a made-up profile."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from rtbench.harness import common
from rtbench.metrics import _kernels

METRICS = common.BENCH_DIR / "metrics"
MS = 1_000_000


def reader(name):
    return common.load_module(METRICS / f"{name}.py")


@pytest.fixture(scope="module", autouse=True)
def _spans():
    """The readers' helper, imported here and not at collection: importing
    it turns the program's span recorder on, which is turned off and
    emptied again once this module's tests are done."""
    from rtbench.metrics import _spans

    yield _spans
    if _spans.RECORDER is not None:
        _spans.RECORDER.disable()
        _spans.RECORDER.clear()


class Timeline:
    """Spans as the program's recorder keeps them, built root by root."""

    def __init__(self):
        self.spans, self.sid, self.t = [], 0, 0

    def root(self, name, phases, profiled=False, **attrs):
        """A root ``name`` whose children are ``phases`` [(name, ms)], one
        after another, and whose own time is 1 ms more."""
        self.sid += 1
        rid, start = self.sid, self.t
        for child, ms in phases:
            self.sid += 1
            self.spans.append(SimpleNamespace(
                name=child, sid=self.sid, parent=rid, rid=rid, start=self.t,
                end=self.t + ms * MS, profiled=profiled, attrs={}))
            self.t += ms * MS
        self.t += MS
        self.spans.append(SimpleNamespace(
            name=name, sid=rid, parent=None, rid=rid, start=start,
            end=self.t, profiled=profiled, attrs=attrs))


def frames():
    tl = Timeline()
    for i, (prep, enq, wait) in enumerate([(30, 5, 200), (32, 6, 210),
                                           (34, 7, 190)]):
        tl.root("frame", [("frame.prepare", prep), ("frame.enqueue", enq),
                          ("frame.wait", wait), ("frame.settle", 2),
                          ("frame.scatter", 14 + i)],
                device_ms=260.0 + 10 * i)
    # the profiled frames are slower and are left out
    tl.root("frame", [("frame.prepare", 90), ("frame.enqueue", 80),
                      ("frame.wait", 900), ("frame.settle", 9),
                      ("frame.scatter", 90)], profiled=True, device_ms=999.0)
    # the first frame's capture, nested in its enqueue, is a span of its
    # own and touches no reader but warmup_s
    tl.spans.append(SimpleNamespace(
        name="capture.warmup", sid=99, parent=98, rid=1, start=0,
        end=1500 * MS, profiled=False, attrs={}))
    return tl.spans


def steps():
    tl = Timeline()
    for i in range(3):
        tl.root("step", [("step.update", 1), ("train.forward", 4 + i),
                         ("train.backward", 3), ("train.combine", 1),
                         ("train.forward", 4), ("train.backward", 3 + i),
                         ("train.combine", 1), ("train.settle", 20 + i),
                         ("train.combine", 2), ("step.update", 2)],
                device_ms=50.0 + i)
    tl.root("step", [("train.forward", 400), ("train.settle", 400)],
            profiled=True, device_ms=900.0)
    # a pose: loss_and_grad is the root
    tl.root("loss_and_grad", [("train.forward", 6), ("train.backward", 8),
                              ("train.combine", 3), ("train.settle", 11)],
            device_ms=21.0)
    return tl.spans


@pytest.fixture
def recorded(monkeypatch, _spans):
    """Patches the spans the readers see."""
    def use(spans):
        monkeypatch.setattr(_spans, "spans", lambda: spans)
    return use


def frame_layer(**counters):
    p = dict(units=3, wall_s=1.0, counters=counters, kernels={
        "table_gather_kernel": dict(us=600.0, count=300),
        "table_gather_grad_kernel": dict(us=400.0, count=30),
        "mesh_walk_kernel<false>(WalkArgs)": dict(us=3000.0, count=200),
        "mesh_walk_kernel<true>(WalkArgs)": dict(us=1000.0, count=100),
        "mesh_finish_kernel": dict(us=50.0, count=300)})
    return dict(kind="frame", unit_s=0.3, profile=p)


def test_frame_span_readers_take_the_median_of_unprofiled_frames(recorded):
    recorded(frames())
    lay = frame_layer()
    assert reader("prepare_ms.frame").read(lay) == pytest.approx(32.0)
    assert reader("enqueue_ms.frame").read(lay) == pytest.approx(6.0)
    assert reader("wait_ms.frame").read(lay) == pytest.approx(200.0)
    # settle 2 + scatter 14, 15, 16
    assert reader("finish_ms.frame").read(lay) == pytest.approx(17.0)
    assert reader("device_span_ms.frame").read(lay) == pytest.approx(270.0)
    assert reader("warmup_s").read(lay) == pytest.approx(1.5)
    for name in ("launch_ms.train", "settle_ms.train", "combine_ms.train",
                 "update_ms.train", "device_span_ms.train"):
        assert reader(name).read(lay) is None, name


def test_train_span_readers_sum_a_step_and_take_its_median(recorded,
                                                            _spans):
    spans = steps()
    recorded(spans)
    lay = dict(kind="train", unit_s=0.06, profile=None)
    # step i: forward 4 + i + 4, backward 3 + 3 + i: 14, 16, 18; the pose
    # root 14
    assert reader("launch_ms.train").read(lay) == pytest.approx(15.0)
    # combine 1 + 1 + 2 a step, 3 the pose
    assert reader("combine_ms.train").read(lay) == pytest.approx(4.0)
    assert reader("settle_ms.train").read(lay) == pytest.approx(20.5)
    # step.update: the pose has none and is left out
    assert reader("update_ms.train").read(lay) == pytest.approx(3.0)
    assert reader("device_span_ms.train").read(lay) == pytest.approx(50.5)
    assert reader("prepare_ms.frame").read(lay) is None
    assert reader("warmup_s").read(lay) is None
    # a loss_and_grad inside a step is no root of its own
    assert set(_spans.per_root_ns(spans, _spans.TRAIN_ROOTS,
                                  ("train.settle",))) == {1, 12, 23, 37}


def test_nothing_without_spans_or_counters(recorded):
    recorded([])
    lay = frame_layer()
    for name in ("prepare_ms.frame", "enqueue_ms.frame", "wait_ms.frame",
                 "finish_ms.frame", "device_span_ms.frame", "warmup_s",
                 "gather_roofline.frame", "k1_roofline.frame"):
        assert reader(name).read(lay) is None, name
    tl = Timeline()
    tl.root("frame", [("frame.prepare", 5)], profiled=True, device_ms=1.0)
    recorded(tl.spans)
    assert reader("prepare_ms.frame").read(lay) is None
    assert reader("device_span_ms.frame").read(lay) is None
    train = dict(kind="train", unit_s=0.03, profile=None)
    assert reader("k1_roofline.train").read(train) is None


def test_gather_roofline_of_a_frame():
    lay = frame_layer(gather_bytes=2_010_000_000)
    # 2.01 GB over 3.35 TB/s = 600 us, of 1,000 us of gathers
    assert reader("gather_roofline.frame").read(lay) == pytest.approx(60.0)
    assert reader("gather_roofline.frame").read(
        dict(lay, kind="train")) is None


def test_k1_roofline_of_frames_and_steps():
    tests = 1_000_000_000
    lay = frame_layer(k1_tests=tests)
    # 5e10 operations over 67 TFLOP/s, over 4 ms of the walk
    want = 100 * 50 * tests / _kernels.PEAK_F32_FLOPS / 4e-3
    assert reader("k1_roofline.frame").read(lay) == pytest.approx(want)
    assert reader("k1_roofline.train").read(lay) is None
    assert reader("k1_roofline.train").read(
        dict(lay, kind="train")) == pytest.approx(want)
    for k in list(lay["profile"]["kernels"]):
        if "mesh_walk" in k:
            del lay["profile"]["kernels"][k]
    assert reader("k1_roofline.frame").read(lay) is None


# A traced flagship.frame run reports the harness's per-layer metrics and
# the program's own, and no others.
FLAGSHIP_FRAME_TRACED = {
    "parse_build_s", "capture_s", "idle_share.frame", "slow_frames.frame",
    "device_ops.frame", "torch_ops_ms.frame", "gather_ms.frame",
    "prepare_ms.frame", "enqueue_ms.frame", "wait_ms.frame",
    "finish_ms.frame", "device_span_ms.frame", "warmup_s",
    "gather_roofline.frame"}


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reports_the_program_metrics():
    """One short traced run of flagship.frame through the command the
    benchmark runs, in a process of its own: every span and counter
    metric of the cell is in the line, and the gathers' roofline reads
    under 100%. Skips itself without a card (decided in the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no NVIDIA GPU: the benchmark runs only on the card")
    res = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "flagship.frame",
         "--seed", str(2 ** 33 + 3), "--seconds", "2", "--trace", "1"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    got = line["metrics"]
    # a reader that finds nothing leaves its metric out of the line
    assert set(got) == FLAGSHIP_FRAME_TRACED
    assert 0 < got["gather_roofline.frame"]["value"] < 100
