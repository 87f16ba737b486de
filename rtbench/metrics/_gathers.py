"""The gathers' byte bound: a frozen copy of chip_smoke.py's
``GatherRecorder`` and of the bound of its ``gather_numbers``, so that a
later edit of the smoke test cannot move this yardstick.

The bound counts each input byte read once and each output byte written
once: a lookup's indices and its table read, its rows written; where the
table takes a gradient, the backward's indices and incoming rows read and
the table's gradient written."""

from __future__ import annotations

from rtbench.metrics._kernels import PEAK_BYTES_PER_S


class GatherRecorder:
    """Wraps ops.gather_cuda.table_gather (as intersect.table_gather calls
    it) and counts every call made outside a capture by (G, K, indices,
    dtype, whether the table takes a gradient); the calls still go
    through."""

    def __init__(self, ga):
        self.ga = ga
        self.calls = {}

    def __enter__(self):
        self.orig = self.ga.table_gather
        self.ga.table_gather = self
        return self

    def __exit__(self, *exc):
        self.ga.table_gather = self.orig

    def __call__(self, table, idx):
        import torch

        if not (table.is_cuda and torch.cuda.is_current_stream_capturing()):
            g = table.shape[0]
            k = table.numel() // max(g, 1)
            grad = table.requires_grad and torch.is_grad_enabled()
            key = (g, k, idx.numel(), str(table.dtype).replace("torch.", ""),
                   grad, idx.element_size(), table.element_size())
            self.calls[key] = self.calls.get(key, 0) + 1
        return self.orig(table, idx)

    def summary(self):
        """The calls as [G, K, indices, dtype, differentiated, index bytes,
        table element bytes, count], largest first."""
        return [[*key, n] for key, n in sorted(
            self.calls.items(), key=lambda kv: -kv[0][2] * kv[0][1])]


def call_bytes(g, k, n, grad, ib, es):
    """The bytes one call must move: forward, and backward where the
    table takes a gradient (the gradient rows in f32)."""
    fwd = n * ib + n * k * es + g * k * es
    bwd = n * ib + n * k * 4 + g * k * 4 if grad else 0
    return fwd + bwd


def bound_s(calls):
    """The least time the recorded calls could take on the H100: their
    bytes over its 3.35 TB/s."""
    total = sum(call_bytes(g, k, n, grad, ib, es) * count
                for g, k, n, _, grad, ib, es, count in calls)
    return total / PEAK_BYTES_PER_S
