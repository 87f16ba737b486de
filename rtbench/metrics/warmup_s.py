"""Seconds the tile and train programs spent running their parts eagerly
before capturing them (the spans ``capture.warmup``, summed over the
run): the part of ``capture_s`` that runs kernels."""

from rtbench.metrics import _spans


def read(layer):
    return _spans.total_s("capture.warmup")
