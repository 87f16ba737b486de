"""The level control's plain decision (``ops/graph_cuda.level_control_plain``,
the plain version of ``csrc/tile_graph.cu``'s ``level_control_kernel``)
on the CPU:

* its flags and its level-log entry against ``render.level_width``, for
  every live count from 0 to ``rows``, at 4,096 and 16,384 rows, on
  levels that pack and levels that do not, with and without the dead
  level, and ``graph_cuda.level_control_cpu`` (the CPU programs'
  decision) writing the same into buffers;
* the branch table the kernel takes (``graph_cuda.branch_codes``) against
  ``render.level_branches``;
* the level logs of a CPU tile program and a CPU train program, microbatch
  by microbatch, against the plain decision of the live counts the eager
  loop (``graphs=False``) met, and ``levels`` against the eager widths.

The kernel itself is held against the plain decision on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import tile_program as TP
from raytracer_tpu_torch.core import train_program as TPG
from raytracer_tpu_torch.ops import graph_cuda as GC
from raytracer_tpu_torch.parallel import partition_scene, render_loss_and_grad
from raytracer_tpu_torch.parallel import train as P
from test_torch_tile_control import STATICS, check_plain_decision, one_bounce
from test_torch_tile_program import case
from test_torch_train_control import paths_rays, paths_scene


@pytest.mark.parametrize("dead", [False, True], ids=["live", "dead"])
@pytest.mark.parametrize("rows", [4096, 16384])
@pytest.mark.parametrize("kind", ["mesh", "spheres"])
def test_plain_decision_equals_predicates_and_width(kind, rows, dead):
    check_plain_decision(STATICS[kind], rows, dead)


@pytest.mark.parametrize("dead", [False, True], ids=["live", "dead"])
@pytest.mark.parametrize("kind", list(STATICS))
def test_branch_codes_equal_level_branches(kind, dead):
    for rows in (1024, 4096, 16384):
        branches = R.level_branches(STATICS[kind], rows, dead=dead)
        codes = GC.branch_codes(branches)
        assert len(codes) == len(branches) <= GC.MAX_BRANCHES
        decoded = tuple(None if c == GC.CODE_WHOLE else R.DEAD
                        if c == GC.CODE_DEAD else c for c in codes)
        assert decoded == branches
        assert all(c > 0 for c in codes if c not in (GC.CODE_WHOLE,
                                                     GC.CODE_DEAD))


def _recorded(monkeypatch, owner):
    """Records, per call of ``owner.color_at``, the (rows, live count,
    width) of each level after the first that the eager loop ran."""
    calls, real_width, real_color_at = [], R.level_width, owner.color_at

    def color_at(*a, **kw):
        calls.append([])
        return real_color_at(*a, **kw)

    def level_width(st, rows, n_live, **kw):
        width = real_width(st, rows, n_live, **kw)
        calls[-1].append((rows, n_live, width))
        return width

    monkeypatch.setattr(owner, "color_at", color_at)
    monkeypatch.setattr(R, "level_width", level_width)
    return calls


def _check_logs(logs, eager, level_rows, branches):
    """Each log row against the plain decision of the eager live counts:
    0 at level 0, the decision's entry where the eager loop ran the
    level, -1 after (no live ray: skipped, or the dead level)."""
    assert len(logs) == len(eager)
    for log, ran in zip(logs, eager):
        assert log[0] == 0 and len(log) == len(level_rows)
        for level in range(1, len(level_rows)):
            codes = GC.branch_codes(branches[level])
            n_live = ran[level - 1][1] if level <= len(ran) else 0
            if level <= len(ran):
                assert ran[level - 1][0] == level_rows[level]
            _, entry = GC.level_control_plain(torch.tensor(n_live),
                                              level_rows[level], codes)
            assert log[level] == int(entry), (log, ran)


@pytest.mark.parametrize("name", ["one_bounce", "glass_mesh4"])
def test_tile_program_logs_equal_plain_decision(name, monkeypatch):
    if name == "one_bounce":
        (sc, cam), opts = one_bounce(), dict(tile_rays=256)
    else:
        sc, cam, opts = case(name)
    eager = _recorded(monkeypatch, R)
    want = R.render(sc, cam, graphs=False, **opts)
    monkeypatch.undo()
    got = R.render(sc, cam, **opts)
    np.testing.assert_array_equal(got, want)
    prog = TP.program_of(sc)
    n = prog.frame_stats["tiles"]
    logs = prog.bufs[("logs", (n, len(prog.rows)), torch.int32)].tolist()
    _check_logs(logs, eager, prog.rows, prog.branches)
    levels = [(lv, r, w) for lv, r, w in prog.levels if lv]
    assert levels == [(lv + 1, r, w) for ran in eager
                      for lv, (r, _, w) in enumerate(ran)]


def test_train_program_logs_equal_plain_decision(monkeypatch):
    """Two microbatches on different paths (the first dead from level 1),
    graphed on the CPU against the eager step."""
    sc = paths_scene()
    o, d, target = paths_rays()
    params, recombine = partition_scene(sc)
    eager = _recorded(monkeypatch, P)
    want = render_loss_and_grad(params, recombine, o, d, target, n_micro=2,
                                remat=False, graphs=False)
    monkeypatch.undo()
    logs, real_send = [], TPG.TrainProgram._send_log

    def send_log(self):
        logs.append(self.log.tolist())
        return real_send(self)

    monkeypatch.setattr(TPG.TrainProgram, "_send_log", send_log)
    got = render_loss_and_grad(params, recombine, o, d, target, n_micro=2,
                               remat=False)
    monkeypatch.undo()
    assert torch.equal(got[0], want[0])
    prog = TPG.programs()[0]
    branches = {0: None, **prog.branches}
    _check_logs(logs, eager, prog.level_rows, branches)
    assert logs[0][1] == -1 and logs[1][1] != -1       # the paths differ
    levels = [(lv, r, w) for lv, r, w in prog.levels if lv]
    assert levels == [(lv + 1, r, w) for ran in eager
                      for lv, (r, _, w) in enumerate(ran)]
