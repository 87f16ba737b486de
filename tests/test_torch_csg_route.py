"""Which CSG filter calls take ``csg_filter_kernel`` (``ops/csg_cuda.py``)
and which a plain filter (``csg._filter_pairwise`` / ``_filter_sorted``),
the counters that tell them apart ("csg" and "csg_plain" in
``mesh_cuda.launch_counts``), and the kernel's packed plan and bitwise
algorithm (``csg_cases.filter_bits``, the kernel's steps in numpy)
against the plain filter.

On the CPU only the plain filters run; the rule's CUDA side is checked on
stand-ins that carry a CUDA device and a ``requires_grad`` flag (the
kernel itself is checked on the card, ``tests/test_torch_cuda.py``).
"""

import types

import numpy as np
import pytest
import torch

from csg_cases import filter_bits, random_trees, random_ts
from raytracer_tpu_torch import scenes
from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.core import csg as CSG
from raytracer_tpu_torch.core import intersect as I
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import tile_program as TP
from raytracer_tpu_torch.ops import csg_cuda as CC
from raytracer_tpu_torch.ops import mesh_cuda as MC
from raytracer_tpu_torch.scene import build_scene, specs as S
from raytracer_tpu_torch.scene.yaml_scene import parse_scene


def _csg_area(hsize=32, vsize=18):
    cam, sc = parse_scene(scenes.csg_area_yaml(hsize, vsize), device="cpu")
    return cam, sc


def _chain(n):
    """A left-leaning chain of n unions over n+1 spheres on x."""
    tree = S.Sphere()
    for i in range(n):
        tree = S.Csg("union", tree, S.Sphere(
            transform=tf.translation(3.0 * (i + 1), 0.0, 0.0)))
    return tree


def _csg_rs_tree():
    """examples/csg.rs's tree: (sphere x1.3 intersect a cube turned pi/3)
    minus the union of three radius-0.6 infinite cylinders."""
    outer = S.Csg("intersect", S.Sphere(transform=tf.scaling(1.3, 1.3, 1.3)),
                  S.Cube(transform=tf.rotation_y(np.pi / 3)))
    cyl = [S.Cylinder(transform=tf.Transform().scaling(0.6, 0.6, 0.6)
                      ._apply(m).rotation_y(np.pi / 3).matrix)
           for m in (np.eye(4), tf.rotation_x(np.pi / 2),
                     tf.rotation_z(np.pi / 2))]
    return S.Csg("difference", outer,
                 S.Csg("union", S.Csg("union", cyl[0], cyl[1]), cyl[2]))


def _scene(name):
    if name == "csg_area":
        return _csg_area()[1]
    root = {"csg_rs": _csg_rs_tree, "chain_15": lambda: _chain(15),
            "chain_16": lambda: _chain(16)}[name]()
    return build_scene([S.PointLight(position=(0, 5, -5)), S.Plane(),
                        S.Sphere(transform=tf.translation(0, 0, 9)), root],
                       device="cpu")


@pytest.mark.parametrize("kind", ["hits", "shadow"])
@pytest.mark.parametrize("name", ["csg_area", "csg_rs", "chain_15"])
def test_packed_plan_agrees_with_node_plan(name, kind):
    """Each root's packed plan holds _node_plan's ops and bool masks as
    32-bit words over the root's columns, the table's other columns, and
    the table's width; csg_area's root is the whole 16-column row,
    csg.rs's tree 4 op nodes."""
    sc = _scene(name)
    gids, _ = I.static_columns(sc, kind)
    plans = CSG._root_plans(sc, gids)
    assert len(plans) == 1
    idx, pairwise, plan, packed = plans[0]
    cols = idx.tolist()
    assert pairwise and packed is not None
    assert packed.cols.tolist() == cols and packed.n_cols == len(gids)
    assert len(plan) == len(packed.ops) == (15 if name == "chain_15" else 4)
    bit = 1 << np.arange(len(cols))
    for (op, under, left), p_op, p_under, p_left in zip(
            plan, packed.ops, packed.under, packed.left):
        assert op == p_op
        assert int((under.numpy() * bit).sum()) == int(p_under)
        assert int((left.numpy() * bit).sum()) == int(p_left)
        assert int(p_left) & ~int(p_under) == 0
    others = [] if packed.others is None else packed.others.tolist()
    assert sorted(others + cols) == list(range(len(gids)))
    if name == "csg_area":
        assert len(gids) == len(cols) == 16 and not others
    else:
        assert others


@pytest.mark.parametrize("name", ["csg_area", "csg_rs"])
def test_filter_bits_matches_pairwise_on_scene_plans(name):
    """The kernel's algorithm with the packed plan equals apply_csg's
    plain filter on random tables (signs, +-inf, NaN, ties, signed
    zeros), bit for bit, on the shadow path's layout."""
    sc = _scene(name)
    gids, _ = I.static_columns(sc, "shadow")
    (_, _, _, packed), = CSG._root_plans(sc, gids)
    ts = random_ts(np.random.default_rng(11), 256, len(gids))
    want = CSG.apply_csg(sc, torch.as_tensor(ts), gids, len(gids)).numpy()
    got = filter_bits(ts, packed)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isinf(want).sum() > np.isinf(ts).sum()


@pytest.mark.parametrize("seed", range(4))
def test_filter_bits_matches_pairwise_on_random_trees(seed):
    """Random trees of 2 to 5 nodes at widths 3 to 32, with columns
    outside the tree: the kernel's algorithm equals the pairwise filter
    copied back into the table, bit for bit, and leaves the other columns
    as they were."""
    rng = np.random.default_rng(seed)
    for cols, nodes, under, left, n_cols in random_trees(rng, 6):
        plan = CSG._node_plan(nodes, under, left, "cpu")
        packed = CC.pack_plan(cols, nodes, under, left, n_cols, "cpu")
        ts = random_ts(rng, 96, n_cols)
        t = torch.as_tensor(ts)
        idx = torch.as_tensor(cols)
        want = t.index_copy(1, idx, CSG._filter_pairwise(t[:, idx], plan))
        got = filter_bits(ts, packed)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.numpy().view(np.int32))
        rest = np.setdiff1d(np.arange(n_cols), cols)
        np.testing.assert_array_equal(got[:, rest].view(np.int32),
                                      ts[:, rest].view(np.int32))


@pytest.mark.parametrize("name,width", [("chain_15", 32), ("chain_16", 34)])
def test_roots_wider_than_32_keep_the_plain_path(name, width):
    """A root of 32 columns has a packed plan; one of 34 has none, so the
    route keeps the plain filter there even on cuda under no_grad."""
    sc = _scene(name)
    gids, _ = I.static_columns(sc, "hits")
    (idx, pairwise, _, packed), = CSG._root_plans(sc, gids)
    assert idx.numel() == width and pairwise
    cuda_ts = types.SimpleNamespace(device=torch.device("cuda"),
                                    requires_grad=False)
    with torch.no_grad():
        assert CC.takes_kernel(cuda_ts, packed) == (width <= CC.MAX_COLS)
    assert (packed is None) == (width > CC.MAX_COLS)


@pytest.mark.parametrize("grad", [False, True], ids=["plain_ts", "grad_ts"])
def test_route_on_cuda(grad):
    """On cuda: the kernel under no_grad whatever requires grad; with grad
    enabled, only where ts does not require grad."""
    packed = object()               # any plan: the route reads none
    ts = types.SimpleNamespace(device=torch.device("cuda"),
                               requires_grad=grad)
    with torch.no_grad():
        assert CC.takes_kernel(ts, packed)
    with torch.enable_grad():
        assert CC.takes_kernel(ts, packed) == (not grad)


@pytest.mark.parametrize("grad_mode", [False, True], ids=["no_grad", "grad"])
def test_route_on_cpu_is_plain(grad_mode, monkeypatch):
    """A CPU call takes the plain filter, with or without grad: one
    "csg_plain" a root, the kernel never asked for."""
    def refuse(*a, **kw):
        raise AssertionError("the kernel was asked for on the CPU")

    monkeypatch.setattr(CC, "csg_filter", refuse)
    sc = _scene("csg_rs")
    gids, _ = I.static_columns(sc, "hits")
    ts = torch.as_tensor(random_ts(np.random.default_rng(5), 64, len(gids)))
    MC.reset_launches()
    with torch.set_grad_enabled(grad_mode):
        assert not CC.takes_kernel(ts, CSG._root_plans(sc, gids)[0][3])
        CSG.apply_csg(sc, ts, gids, len(gids))
    assert MC.launch_counts()["csg"] == 0
    assert MC.launch_counts()["csg_plain"] == 1


def test_kernel_refuses_cpu_tensors():
    sc = _scene("csg_rs")
    gids, _ = I.static_columns(sc, "hits")
    packed = CSG._root_plans(sc, gids)[0][3]
    with pytest.raises(ValueError, match="runs on cuda"):
        CC.csg_filter(torch.zeros(4, len(gids)), packed)


def test_cpu_csg_area_frame_counts_only_plain():
    """A CPU csg_area frame: two plain filter calls a level body (the
    shading path's and the area light's shadow path's), no kernel launch;
    the graphs=False frame counts the same."""
    cam, sc = _csg_area()
    counts = []
    for graphs in (True, False):
        MC.reset_launches()
        R.render(sc, cam, quantize=True, graphs=graphs)
        counts.append(MC.launch_counts())
    bodies = len(TP.program_of(sc).levels)
    assert bodies > 0
    for c in counts:
        assert (c["csg"], c["csg_plain"]) == (0, 2 * bodies)


def test_counters_add_and_reset_through_mesh_cuda():
    """``mesh_cuda`` carries the CSG counters as the programs use them: a
    captured graph's delta added per replay, and reset."""
    MC.reset_launches()
    before = MC.host_counts()
    assert before["csg"] == before["csg_plain"] == 0
    MC.add_launches({**{k: 0 for k in before}, "csg": 2, "csg_plain": 1}, 3)
    assert (CC.LAUNCHES["csg"], CC.LAUNCHES["csg_plain"]) == (6, 3)
    MC.reset_launches()
    assert CC.launch_counts() == {"csg": 0, "csg_plain": 0}
