"""The numbers that decide a training cell's ``correct``, from the first
steps of the program and of the reference (or of the control in its
place).

A leaf is one table of the scene (a material column, the light's
position, a pattern's colours ...) or the camera's eye. Each gap is taken
by the worst leaf: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger."""

from __future__ import annotations

import statistics

import numpy as np


def loss_gap(got, want):
    """The largest gap of the steps' losses, over the reference's first
    loss: the fit shrinks the loss step by step, while the pixels on
    which two sound tracers part (coplanar faces, edges) keep their
    share, so a gap over each step's own loss would grow as the fit
    goes on."""
    return max(abs(g - w) for g, w in zip(got, want)) / abs(want[0])


def norm_gap(got, want):
    """``got``, ``want``: {leaf: norm}. The worst leaf's gap, over the
    larger of its reference norm and the median leaf's."""
    med = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in want)


def _norm(x):
    return float(np.linalg.norm(np.asarray(x, np.float64)))


# A leaf is compared only where the reference moves it by this many
# float32 spacings or more: one spacing is then at most a twentieth of the
# move, the limit of grad_gap and change_gap, so rounding alone cannot
# carry the gap to its limit.
MIN_ULPS = 20.0


def spacing(p0):
    """The float32 spacing of a table's values, as a norm: one rounding
    step of the table."""
    p = np.abs(np.asarray(p0, np.float32))
    return float(np.linalg.norm(np.spacing(p).astype(np.float64)))


def sgd_numbers(port_hist, ref_hist, port_losses, ref_losses, lr,
                min_ulps=MIN_ULPS):
    """Numbers of an SGD run: ``*_hist`` [{leaf: table (float32 numpy)}]
    before the first step and after each. The first gradient is worked
    out from the state after one step, (p0 - p1) / lr; the change is the
    one over all the steps. Each compares only the leaves whose reference
    move (the first step for the gradient, all the steps for the change)
    spans ``min_ulps`` spacings of the table or more. Returns ({number:
    value}, the leaves of the gradient, the leaves of the change)."""
    def moved(a, b):
        return [k for k in ref_hist[0] if ref_hist[0][k].size and _norm(
            ref_hist[b][k].astype(np.float64) - ref_hist[a][k])
            >= min_ulps * spacing(ref_hist[0][k])]

    g_leaves, c_leaves = moved(0, 1), moved(0, -1)

    def grads(hist):
        return {k: _norm((hist[0][k].astype(np.float64) - hist[1][k]) / lr)
                for k in g_leaves}

    def change(hist):
        return {k: _norm(hist[-1][k].astype(np.float64) - hist[0][k])
                for k in c_leaves}

    nums = dict(loss_gap=loss_gap(port_losses, ref_losses),
                grad_gap=norm_gap(grads(port_hist), grads(ref_hist)),
                change_gap=norm_gap(change(port_hist), change(ref_hist)))
    return nums, g_leaves, c_leaves


def adam_numbers(port_losses, ref_losses, port_moments, ref_moments,
                 beta1=0.9):
    """Numbers of an Adam run on one leaf (the eye): the first gradient
    worked out from Adam's first moment after one step, m / (1 - beta1);
    and that moment after the last step, which carries every step's
    gradient. (The eye's change is not compared: Adam moves each
    coordinate by about lr whatever its gradient's size, so a coordinate
    whose gradient is near 0 moves by a whole step on a rounding gap.)
    ``*_moments``: the first moment after the first and the last step."""
    def norm(m):
        return _norm(np.asarray(m, np.float64) / (1 - beta1))

    g_p, g_r = norm(port_moments[0]), norm(ref_moments[0])
    m_p, m_r = norm(port_moments[-1]), norm(ref_moments[-1])
    return dict(loss_gap=loss_gap(port_losses, ref_losses),
                grad_gap=abs(g_p - g_r) / g_r,
                moment_gap=abs(m_p - m_r) / m_r)
