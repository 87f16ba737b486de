"""The span recorder of ``raytracer_tpu_torch/utils/profiling.py`` and the
spans and counters the port records with it, on the CPU: nesting,
parents, request ids, self time, the buffer's bound; the recorder off
(no clock read, no span, no read of the card by ``launch_counts``);
``profiled`` under torch.profiler; ``trace_profile``'s trace with the
spans on the profiler's clock; the phases of a frame and of a train
step; graphed and eager bit-equal with the recorder on and off; and the
gathers' byte rule against the benchmark's."""

import collections
import json

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import scenes
from raytracer_tpu_torch.camera import ray_grid
from raytracer_tpu_torch.core import tile_program as TP
from raytracer_tpu_torch.core.render import render
from raytracer_tpu_torch.ops import gather_cuda as GA
from raytracer_tpu_torch.ops import mesh_cuda as MC
from raytracer_tpu_torch.parallel import (
    partition_scene, render_loss_and_grad, train_step)
from raytracer_tpu_torch.scene import build_scene
from raytracer_tpu_torch.utils import profiling as P

FRAME_PHASES = ("frame.prepare", "frame.enqueue", "frame.wait",
                "frame.settle", "frame.scatter")


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty again after the test."""
    P.clear()
    P.enable()
    yield P
    P.disable()
    P.clear()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nesting_parents_request_ids_and_self_time(recorder, monkeypatch):
    clock = iter(range(0, 10_000, 10))
    monkeypatch.setattr(P, "_now", lambda: next(clock))
    with P.span("frame") as root:                   # 0 .. 70
        root.attrs["tiles"] = 3
        with P.span("frame.prepare"):               # 10 .. 20
            pass
        with P.span("frame.enqueue"):               # 30 .. 60
            with P.span("frame.capture"):           # 40 .. 50
                assert P.current_root() is root
    with P.span("frame") as other:                  # 80 .. 90
        pass
    got = by_name(P.spans())
    prep, enq, cap = (got[k][0] for k in ("frame.prepare", "frame.enqueue",
                                          "frame.capture"))
    assert root.parent is None and root.rid == root.sid
    assert prep.parent == enq.parent == root.sid
    assert cap.parent == enq.sid
    assert {s.rid for s in (root, prep, enq, cap)} == {root.sid}
    assert other.rid == other.sid != root.sid
    assert root.attrs == {"tiles": 3}
    assert (root.duration_ns, root.self_ns) == (70, 70 - 10 - 30)
    assert (enq.duration_ns, enq.self_ns) == (30, 20)
    assert cap.self_ns == cap.duration_ns == 10
    # kept in the order they ended; a root after its children
    assert [s.name for s in P.spans()] == [
        "frame.prepare", "frame.capture", "frame.enqueue", "frame", "frame"]
    assert P.current_root() is None


def test_the_bound_drops_the_oldest_and_counts_them(recorder, monkeypatch):
    monkeypatch.setattr(P, "_buf", collections.deque(maxlen=4))
    for i in range(7):
        with P.span(f"s{i}"):
            pass
    assert [s.name for s in P.spans()] == ["s3", "s4", "s5", "s6"]
    assert P.dropped() == 3
    P.clear()
    assert P.spans() == [] and P.dropped() == 0


def test_off_records_nothing_reads_no_clock_and_leaves_the_card(monkeypatch):
    """Off, span() is the shared no-op and reads no clock;
    launch_counts() gives k1_tests 0 without synchronizing or reading a
    counter. On, it reads them: in all and by K1's mode."""
    P.disable()
    P.clear()

    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(P, "_now", no_clock)
    for _ in range(3):
        sp = P.span("frame.prepare")
        assert sp is P.NOOP
        with sp:
            pass
    assert P.spans() == []

    touched = []

    class Counter:
        def tolist(self):
            touched.append("tolist")
            return [7, 0, 5]

    monkeypatch.setitem(MC._TESTS, torch.device("cuda", 0), Counter())
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: touched.append("sync"))
    assert MC.launch_counts()["k1_tests"] == 0
    assert MC.k1_tests() == 0
    assert touched == []
    monkeypatch.setattr(P, "_now", lambda: 0)
    P.enable()
    try:
        counts = MC.launch_counts()
        assert counts["k1_tests"] == 12
        assert (counts["k1_tests_nearest"], counts["k1_tests_any_hit"],
                counts["k1_tests_behind"]) == (7, 0, 5)
        assert touched == ["sync", "tolist"]
    finally:
        P.disable()


def test_timed_keeps_its_clock_while_off():
    P.disable()
    P.clear()
    with P.timed("frame.capture") as sp:
        sum(range(1000))
    assert sp.seconds > 0 and P.spans() == []


def test_profiled_marks_spans_under_the_profiler(recorder):
    with P.span("outside"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with P.span("inside"):
            pass
    got = by_name(P.spans())
    assert got["outside"][0].profiled is False
    assert got["inside"][0].profiled is True


def test_trace_profile_writes_the_spans_on_the_profilers_clock(tmp_path):
    """trace.json holds the spans as a track of their own, and a span
    around a torch op encloses the op's Kineto interval once converted,
    within 50 us; the recorder is off again after the block."""
    P.disable()
    P.clear()
    a = torch.randn(300, 300)
    with P.trace_profile(str(tmp_path)) as prof:
        with P.span("matmul") as sp:
            a @ a
    assert not P.enabled()
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm")
    slack = 50_000
    assert P.unix_ns(sp.start) <= ev.start_ns() + slack
    assert P.unix_ns(sp.end) >= ev.end_ns() - slack
    trace = json.loads((tmp_path / "trace.json").read_text())
    events = trace["traceEvents"]
    mine = [e for e in events if e.get("pid") == "program spans"
            and e.get("ph") == "X"]
    assert [e["name"] for e in mine] == ["matmul"]
    mm = next(e for e in events if e.get("name") == "aten::mm")
    assert mine[0]["ts"] <= mm["ts"] + slack / 1e3
    assert mine[0]["ts"] + mine[0]["dur"] >= mm["ts"] + mm["dur"] - slack / 1e3
    P.clear()


def test_device_spans_attach_once_their_end_has_completed(recorder):
    class Event:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

        def elapsed_time(self, end):
            return 4.5

    end = Event(False)
    with P.span("step") as root:
        P.device_span(Event(True), end)
        P.resolve_device_spans()
        assert "device_ms" not in root.attrs
    end.done = True
    P.spans()
    assert root.attrs["device_ms"] == 4.5
    P.device_span(Event(True), Event(True))       # no root: dropped
    P.resolve_device_spans()


def flagship(h=32, v=16):
    items, cam = scenes.flagship(h, v)
    return build_scene(items, device="cpu"), cam


def test_a_cpu_frame_records_each_phase_once(recorder):
    sc, cam = flagship()
    render(sc, cam, quantize=True)
    got = by_name(P.spans())
    (root,) = got.pop("frame")
    assert {k: len(v) for k, v in got.items()} == dict.fromkeys(
        FRAME_PHASES, 1)
    assert all(s[0].rid == root.sid and s[0].parent == root.sid
               for s in got.values())
    assert sum(s[0].duration_ns for s in got.values()) <= root.duration_ns
    # the CPU program captures nothing: no capture span, capture_s 0
    capture = sum(s.seconds for s in P.spans() if s.name == "frame.capture")
    assert capture == TP.program_of(sc).stats["capture_s"] == 0.0


def test_a_cpu_train_step_records_each_microbatch(recorder):
    sc, cam = flagship(16, 16)
    o, d = ray_grid(cam, device="cpu")
    train_step(sc, o, d, torch.zeros_like(o), n_micro=2)
    got = by_name(P.spans())
    (root,) = got["step"]
    assert {k: len(v) for k, v in got.items()} == {
        "step": 1, "step.update": 2, "loss_and_grad": 1, "train.forward": 2,
        "train.backward": 2, "train.combine": 3, "train.settle": 1}
    assert {s.rid for s in P.spans()} == {root.sid}
    P.clear()
    params, recombine = partition_scene(sc)
    render_loss_and_grad(params, recombine, o, d, torch.zeros_like(o))
    roots = [s for s in P.spans() if s.parent is None]
    assert [s.name for s in roots] == ["loss_and_grad"]


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_graphed_equals_eager_with_the_recorder(on, one_thread):
    P.clear()
    (P.enable if on else P.disable)()
    try:
        sc, cam = flagship(24, 16)
        np.testing.assert_array_equal(
            render(sc, cam, quantize=True),
            render(sc, cam, quantize=True, graphs=False))
        o, d = ray_grid(cam, device="cpu")
        target = torch.full_like(o, 0.2)
        (lg, sg), (le, se) = (train_step(sc, o, d, target, lr=0.05,
                                         n_micro=2, graphs=graphs)
                              for graphs in (True, False))
        assert lg.numpy().tobytes() == le.numpy().tobytes()
        pg, pe = partition_scene(sg)[0], partition_scene(se)[0]
        for k in pe:
            assert pg[k].numpy().tobytes() == pe[k].numpy().tobytes(), k
        assert bool(P.spans()) == on
    finally:
        P.disable()
        P.clear()


@pytest.mark.parametrize("g,k,n,es,ib", [
    (4, 10, 524_288, 4, 8), (1025, 3, 16_384, 4, 4), (5, 1, 131_072, 1, 8),
    (4_194_304, 3, 524_288, 4, 8), (1, 27, 7, 4, 4)])
def test_gather_bytes_follow_the_benchmarks_rule(g, k, n, es, ib):
    from rtbench.metrics._gathers import call_bytes

    fwd = GA.forward_bytes(n, g, k * es, ib)
    assert fwd == call_bytes(g, k, n, False, ib, es)
    assert fwd + GA.backward_bytes(n, g, k, ib) == call_bytes(
        g, k, n, True, ib, es)
    assert "gather_bytes" in GA.launch_counts()
    assert "gather_bytes" in MC.launch_counts()
