"""The benchmark's arithmetic on synthetic input: the per-layer readers
on a made-up profile, the gathers' byte bound on made-up calls, the idle
gaps of a made-up timeline, and the statistics of frame_s
and step_s."""

import statistics

import pytest

from rtbench.harness import common, compare, trace
from rtbench.harness.common import load_module
from rtbench.metrics import _gathers, _kernels

METRICS = common.BENCH_DIR / "metrics"


def reader(name):
    return load_module(METRICS / f"{name}.py")


def profile(units=2):
    kernels = {
        "mesh_walk_kernel<false>(Args)": dict(us=3000.0, count=20),
        "mesh_walk_kernel<true>(Args)": dict(us=1000.0, count=10),
        "mesh_finish_kernel": dict(us=100.0, count=30),
        "live_supergroups_kernel": dict(us=400.0, count=30),
        "table_gather_kernel": dict(us=500.0, count=100),
        "table_gather_grad_kernel": dict(us=300.0, count=20),
        "level_control_kernel": dict(us=50.0, count=8),
        "void at::native::elementwise_kernel<...>": dict(us=14650.0,
                                                         count=900),
    }
    counters = dict(k1=30, nearest=20, any_hit=10, behind=0, prepass=30,
                    gather=100, gather_grad=20)
    return dict(units=units, wall_s=0.05, kernels=kernels, counters=counters)


def layer(kind, **kw):
    return dict(kind=kind, unit_s=0.02, parse_build_s=1.5, capture_s=4.0,
                profile=profile(), **kw)


def test_kernel_sums():
    p = profile()
    assert _kernels.busy_us(p) == 20000.0
    assert _kernels.events(p) == 1118
    assert _kernels.kernel_sum(p, _kernels.K1_KERNELS) == (4500.0, 90)
    assert _kernels.kernel_sum(p, _kernels.GATHER_KERNELS) == (800.0, 120)
    tot = _kernels.device_totals(p)
    assert tot["mesh_walk_kernel<false>"] == dict(ms=3.0, launches=20)
    assert tot["backward_control_kernel"] == dict(ms=0.0, launches=0)
    assert _kernels.counted_k1(p) is True


def test_readers_on_a_frame():
    lay = layer("frame")
    # 20 ms busy over 2 frames = 10 ms a frame, of 20 ms unprofiled
    assert reader("idle_share.frame").read(lay) == pytest.approx(0.5)
    assert reader("idle_share.train").read(lay) is None
    assert reader("device_ops.frame").read(lay) == 559
    # everything but the hand-written kernels: 14.65 ms over 2 frames
    assert reader("torch_ops_ms.frame").read(lay) == pytest.approx(7.325)
    assert reader("k1_ms.frame").read(lay) == pytest.approx(2.25)
    assert reader("gather_ms.frame").read(lay) == pytest.approx(0.4)
    assert reader("parse_build_s").read(lay) == 1.5
    assert reader("capture_s").read(lay) == 4.0


def test_slow_frames():
    lay = layer("frame", unit_lats=[0.26, 0.31, 0.27, 0.264, 0.30])
    # over 0.286: 0.31 and 0.30
    assert reader("slow_frames.frame").read(lay) == pytest.approx(40.0)
    assert reader("slow_frames.frame").read(layer("frame")) is None
    assert reader("slow_frames.frame").read(
        layer("train", unit_lats=[0.1])) is None


def test_k1_reader_gives_nothing_without_k1_or_when_counts_differ():
    lay = layer("frame")
    for k in _kernels.K1_KERNELS:
        lay["profile"]["kernels"].pop(k + "(Args)", None)
        lay["profile"]["kernels"].pop(k, None)
    assert reader("k1_ms.frame").read(lay) is None
    lay = layer("frame")
    lay["profile"]["counters"]["prepass"] = 29
    assert reader("k1_ms.frame").read(lay) is None
    assert reader("idle_share.frame").read(dict(lay, profile=None)) is None


def test_gather_roofline():
    calls = [[4, 10, 1000, "float32", True, 8, 4, 3],
             [7, 27, 2000, "float32", False, 8, 4, 2]]
    fwd_grad = 1000 * 8 + 1000 * 10 * 4 + 4 * 10 * 4
    bwd = 1000 * 8 + 1000 * 10 * 4 + 4 * 10 * 4
    fwd = 2000 * 8 + 2000 * 27 * 4 + 7 * 27 * 4
    total = 3 * (fwd_grad + bwd) + 2 * fwd
    assert _gathers.bound_s(calls) == pytest.approx(total / 3.35e12)
    lay = layer("train", gather_calls=calls)
    # 800 us of gathers over 2 steps
    want = 100 * (total / 3.35e12) / 400e-6
    assert reader("gather_roofline.train").read(lay) == pytest.approx(want)
    assert reader("gather_roofline.train").read(layer("frame")) is None
    assert reader("gather_roofline.train").read(
        layer("train", gather_calls=[])) is None


def test_idle_gaps():
    device = [(0, 10, "a"), (5, 20, "b"), (50, 60, "c"), (61, 70, "d")]
    host = [(0, 100, "rtbench.frame"), (20, 50, "cudaStreamSynchronize"),
            (59, 62, "aten::copy_")]
    assert trace.idle_gaps(device, host) == [
        ["cudaStreamSynchronize", 30e-6], ["aten::copy_", 1e-6]]
    assert trace.idle_gaps([(0, 1, "a")], []) == []


def test_window_statistics():
    assert common.window_rate(30.0, 100) == 0.3
    with pytest.raises(ValueError):
        common.window_rate(30.0, 0)
    vals = [1.0, 1.1, 0.9, 1.0, 1.05, 0.95]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert common.spread(vals) == pytest.approx((q3 - q1) / 1.0)


def test_the_check_readings_of_a_bound():
    from rtbench import bounds

    vals = [1.0, 1.0, 1.0, 1.0, 1.0, 2.0]
    # the far run out, the rest agree
    assert bounds.tight(vals) == 0.0
    assert common.spread(vals) > 0.2


def test_checks_and_gaps():
    assert common.check(0.1, 0.2)["ok"]
    assert not common.check(0.3, 0.2)["ok"]
    assert not common.check(float("nan"), 0.2)["ok"]
    assert common.check(0.0, 0.0)["ok"]
    assert not common.check(1e-9, 0.0)["ok"]
    assert compare.loss_gap([2.0, 1.1], [2.0, 1.0]) == pytest.approx(0.05)
    # the small leaf is measured against the median leaf's norm
    got = dict(a=1.0, b=2.2, c=0.002)
    want = dict(a=1.0, b=2.0, c=0.001)
    assert compare.norm_gap(got, want) == pytest.approx(0.2 / 2.0)
    assert compare.spacing([1.0]) == pytest.approx(2 ** -23)
