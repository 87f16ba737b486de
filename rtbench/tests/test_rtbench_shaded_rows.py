"""The reader of the rows a frame shades (``shaded_rows.frame``) on
synthetic spans: the median over the unprofiled frames' roots, in
millions; nothing without spans, without the count (as with a program
that records none), or in a train cell."""

from types import SimpleNamespace

import pytest

from rtbench.harness import common

METRICS = common.BENCH_DIR / "metrics"


def reader():
    return common.load_module(METRICS / "shaded_rows.frame.py")


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


def span(name, sid, parent=None, profiled=False, **attrs):
    return SimpleNamespace(name=name, sid=sid, parent=parent,
                           rid=sid if parent is None else parent, start=0,
                           end=1, profiled=profiled, attrs=attrs)


@pytest.fixture
def recorded(monkeypatch, _spans):
    def use(spans):
        monkeypatch.setattr(_spans, "spans", lambda: spans)
    return use


FRAME = dict(kind="frame", unit_s=0.3, profile=None)


def test_median_of_the_unprofiled_frames_in_millions(recorded):
    recorded([
        span("frame", 1, rows_shaded=3_500_000, device_ms=200.0),
        span("frame.settle", 2, parent=1, rows_shaded=1),
        span("frame", 3, rows_shaded=3_400_000),
        span("frame", 4, rows_shaded=3_700_000),
        # profiled frames are left out, and so are roots of other kinds
        span("frame", 5, profiled=True, rows_shaded=99_000_000),
        span("step", 6, rows_shaded=77_000_000),
    ])
    assert reader().read(FRAME) == pytest.approx(3.5)
    assert reader().read(dict(FRAME, kind="train")) is None


def test_nothing_without_spans_or_the_count(recorded):
    recorded([])
    assert reader().read(FRAME) is None
    # a program without the counter: frames with a device span alone
    recorded([span("frame", 1, device_ms=260.0), span("frame", 2)])
    assert reader().read(FRAME) is None
    recorded([span("frame", 1, profiled=True, rows_shaded=1_000_000)])
    assert reader().read(FRAME) is None
