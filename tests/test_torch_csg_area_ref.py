"""The benchmark's CSG and area-light reference (``rtbench/reference/
csg_area.py``) against the port on the CPU, on the csg_area configuration
(``rtbench/configs/csg_area.*``, csg.rs's solid under a 10x10 area
light):

* the reference's CSG filter, written as csg.rs walks a node's sorted
  hits, against ``core.csg.apply_csg`` on the same quadric hits of seeded
  random rays through the tree: the same hits survive;
* the port's frame with the deterministic jitter ``(0.5,)`` against the
  reference's frame with every draw at 0.5, and the configuration's scene
  file against ``scenes.csg_area_yaml``;
* the port's frame under random jitter within the csg_area.frame cell's
  limits (``rtbench/checks/csg_area.frame.json``), and the program with
  either planted fault of ``rtbench/control_area.py`` outside them;
* the area-light count (``area_rays``): tiles x 4,096 x 100 in the tile
  program's stats and on the frame's root span, and on the root span of
  a ``graphs=False`` frame;
* the stage marks (``area_light``, ``csg_filter``): opened under the
  profiler with the span recorder on, and frames equal bit for bit with
  them on and off.

The reference is imported directly, not through the benchmark's harness
(which refuses to run with JAX loaded)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rtbench.control_area import planted  # noqa: E402
from rtbench.harness import common  # noqa: E402
from rtbench.loops import area_frame as A  # noqa: E402
from rtbench.reference import csg_area, tracer  # noqa: E402

from raytracer_tpu_torch import scenes  # noqa: E402
from raytracer_tpu_torch.core import csg as CSG  # noqa: E402
from raytracer_tpu_torch.core import tile_program as TP  # noqa: E402
from raytracer_tpu_torch.core.render import area_rays, render  # noqa: E402
from raytracer_tpu_torch.scene.yaml_scene import parse_scene  # noqa: E402
from raytracer_tpu_torch.utils import profiling as P  # noqa: E402

CONFIGS = common.BENCH_DIR / "configs"
LIMITS = json.loads((common.BENCH_DIR / "checks" / "csg_area.frame.json")
                    .read_text())
SEED = 2 ** 31 + 91
CPU = torch.device("cpu")


def config(size, shift=None):
    cfg = common.load_json(CONFIGS / "csg_area.json")
    cfg["camera"]["hsize"], cfg["camera"]["vsize"] = size
    if shift is not None:
        cfg["color_shift"] = shift
    return cfg, common.load_module(CONFIGS / "csg_area.py")


def port_scene(size, jitter=None, seed=SEED):
    cfg, mod = config(size)
    desc = mod.describe(cfg, seed)
    cam, sc = parse_scene(mod.scene_yaml(cfg, desc), jitter=jitter,
                          device="cpu")
    return desc, cam, sc


@pytest.fixture
def recorder():
    """The span recorder on for a test, off and emptied after it."""
    P.clear()
    P.enable()
    yield P
    P.disable()
    P.clear()


def test_the_reference_filter_keeps_the_hits_apply_csg_keeps():
    desc, _, sc = port_scene((8, 8))
    ref = csg_area.Scene(desc)
    rng = np.random.default_rng(5)
    o = torch.as_tensor(rng.uniform(-3, 3, (4000, 3)), dtype=torch.float32)
    target = torch.as_tensor(rng.uniform(-1, 1, (4000, 3)),
                             dtype=torch.float32)
    d = tracer._normalize(target - o)
    ts, objs = tracer.quadric_ts(ref, o, d)
    # the port's gid of each reference shape, found by its transform
    gid_of = [int(torch.argmin((sc.inv_tf - q_inv.float()).abs().flatten(1)
                               .sum(1))) for q_inv in ref.q_inv]
    assert sorted(gid_of) == list(range(5))
    gids = np.array([gid_of[q] for q in objs], np.int32)
    got = CSG.apply_csg(sc, ts, gids, ts.shape[1])
    got_obj = torch.as_tensor(objs)[None].expand_as(got)
    want, want_obj = csg_area.world_hits(ref, o, d)
    got_t, order = got.sort(dim=1, stable=True)
    got_obj = got_obj.gather(1, order)
    want_t, order = want.sort(dim=1, stable=True)
    want_obj = want_obj.gather(1, order)
    assert torch.equal(got_t, want_t)
    alive = torch.isfinite(want_t)
    assert torch.equal(got_obj[alive], want_obj[alive])
    # the filter removes hits, negative ones among those it walks
    raw = torch.isfinite(ts).sum()
    assert 0 < alive.sum() < raw and bool((want_t[alive] < 0).any())


def test_deterministic_frame_equals_the_reference_and_the_scene_file():
    desc, cam, sc = port_scene((64, 36), jitter=(0.5,))
    got = render(sc, cam, quantize=True)
    want = csg_area.render_u8(csg_area.Scene(desc, jitter=(0.5,)))
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (diff > 1).sum() <= 3 and got.std() > 5
    cfg, mod = config((64, 36), shift=0.0)
    text = mod.scene_yaml(cfg, mod.describe(cfg, SEED))
    frames = [render(s, c, quantize=True) for c, s in (
        parse_scene(text, jitter=(0.5,), device="cpu"),
        parse_scene(scenes.csg_area_yaml(64, 36), jitter=(0.5,),
                    device="cpu"))]
    np.testing.assert_array_equal(*frames)


def checks(desc, frame, seed=SEED):
    want = A.reference_frame(desc, seed, CPU)
    band = A.noise_band(desc, CPU)
    return A.px_off_hard(frame, want, band), A.block_gap(frame, want)


def test_random_jitter_frame_within_the_limits():
    desc, cam, sc = port_scene((64, 36))
    hard, gap = checks(desc, render(sc, cam, quantize=True))
    assert hard <= LIMITS["px_off_hard"] and gap <= LIMITS["block_gap"]


# at 64x36 an 8 x 8 block averages the one-sample fault's hard shadow
# edges and highlights over too large a patch of the solid to show them
# (block_gap 2.7 there, 18.4 at 160x90, 75 at 640x360)
@pytest.mark.parametrize("fault, number", [("csg_union", 0),
                                           ("one_sample", 1)])
def test_each_planted_fault_fails_its_limit(fault, number):
    with planted(fault):
        desc, cam, sc = port_scene((160, 90))
        frame = render(sc, cam, quantize=True)
    got = checks(desc, frame)
    assert got[number] > LIMITS[("px_off_hard", "block_gap")[number]]


def test_area_rays_count_every_sample_ray(recorder):
    # 96 x 54 = 5,184 pixels: two tiles of 4,096 rays
    _, cam, sc = port_scene((96, 54))
    want = 2 * 4096 * 100
    a = render(sc, cam, quantize=True)
    assert TP.program_of(sc).stats["area_rays"] == want
    b = render(sc, cam, quantize=True, graphs=False)
    np.testing.assert_array_equal(a, b)
    roots = [s for s in recorder.spans() if s.parent is None]
    assert [s.attrs["area_rays"] for s in roots] == [want, want]
    assert roots[0].attrs["rows_shaded"] == 2 * 4096
    assert area_rays(sc.static, 4096) == 409_600


@pytest.mark.parametrize("graphs", [True, False], ids=["program", "eager"])
def test_frames_are_equal_with_the_marks_on_and_off(recorder, graphs):
    from torch.profiler import ProfilerActivity, profile

    _, cam, sc = port_scene((64, 36))
    recorder.disable()
    off = render(sc, cam, quantize=True, graphs=graphs)
    recorder.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = render(sc, cam, quantize=True, graphs=graphs)
    np.testing.assert_array_equal(on, off)
    names = {e.name for e in prof.events()}
    assert {"area_light", "csg_filter"} <= names
    # off the profiler, or with the recorder off, a mark is the no-op
    assert P.mark("area_light") is P.NOOP
    recorder.disable()
    with profile(activities=[ProfilerActivity.CPU]):
        assert P.mark("area_light") is P.NOOP
