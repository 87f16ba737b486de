"""CSG and area lights in raytracer_tpu_torch against the JAX package.

* CSG: the oracles of tests/test_csg.py through the port (the truth table,
  the union/intersect/difference/nested/miss filters, the 64-node tree,
  the pairwise filter against the sorted one with t-ties), ``apply_csg``
  against the JAX package's on random tables on both paths, and the
  factored CSG x area-light shadow query against a brute-force oracle.
* Area lights: the oracles of tests/test_shading.py:143-235, the
  deterministic jitter tables against the JAX package's, and frames.

Frames in deterministic jitter mode are held to the JAX package's frame
with the u8 budget (at most 0.5% of pixels more than one step apart). In
seeded mode the two packages draw different random streams, so a seeded
frame is held statistically: the same seed gives the same bytes; the
image means agree within 0.5 u8 step; and the pixels that differ by more
than one step and lie outside the penumbra are at most 0.5% of the frame.
The penumbra is taken as the pixels where the deterministic frames with
every sample at one corner of its cell differ: jitter (0.001,) and
(0.999,) put the samples at the (low, low) and (high, high) corners,
(0.001, 0.999) and (0.999, 0.001) at the other two.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import csg as JCSG
from raytracer_tpu.core import intersect as JI
from raytracer_tpu.core import render as JR
from raytracer_tpu.scene.yaml_scene import parse_scene as jax_parse_scene
from raytracer_tpu_torch import scenes
from raytracer_tpu_torch import transforms as tf
from raytracer_tpu_torch.camera import Camera
from raytracer_tpu_torch.core import csg as CSG
from raytracer_tpu_torch.core import intersect as I
from raytracer_tpu_torch.core import render as R
from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.scene import build_scene, specs as S
from raytracer_tpu_torch.scene.yaml_scene import parse_scene
from torch_port_helpers import assert_same_tables, jax_camera, same_tables

PI = math.pi

# ------------------------------------------------------------------- CSG

TRUTH = [  # csg.rs:187-217: (op, left hit, in left, in right, allowed)
    (T.CSG_UNION, True, True, True, False),
    (T.CSG_UNION, True, True, False, True),
    (T.CSG_UNION, True, False, True, False),
    (T.CSG_UNION, True, False, False, True),
    (T.CSG_UNION, False, True, True, False),
    (T.CSG_UNION, False, True, False, False),
    (T.CSG_UNION, False, False, True, True),
    (T.CSG_UNION, False, False, False, True),
    (T.CSG_INTERSECT, True, True, True, True),
    (T.CSG_INTERSECT, True, True, False, False),
    (T.CSG_INTERSECT, True, False, True, True),
    (T.CSG_INTERSECT, True, False, False, False),
    (T.CSG_INTERSECT, False, True, True, True),
    (T.CSG_INTERSECT, False, True, False, True),
    (T.CSG_INTERSECT, False, False, True, False),
    (T.CSG_INTERSECT, False, False, False, False),
    (T.CSG_DIFFERENCE, True, True, True, False),
    (T.CSG_DIFFERENCE, True, True, False, True),
    (T.CSG_DIFFERENCE, True, False, True, False),
    (T.CSG_DIFFERENCE, True, False, False, True),
    (T.CSG_DIFFERENCE, False, True, True, True),
    (T.CSG_DIFFERENCE, False, True, False, True),
    (T.CSG_DIFFERENCE, False, False, True, False),
    (T.CSG_DIFFERENCE, False, False, False, False),
]


@pytest.mark.parametrize("row", range(len(TRUTH)))
def test_truth_table(row):
    op, lhit, inl, inr, expected = TRUTH[row]
    args = [torch.tensor([x]) for x in (lhit, inl, inr)]
    assert bool(CSG._op_allowed(op, *args)[0]) == expected
    jargs = [jnp.asarray([x]) for x in (lhit, inl, inr)]
    assert bool(JCSG._op_allowed(op, *jargs)[0]) == expected


def hits(scene, origin, direction):
    """The reference's sorted intersection list (finite t only)."""
    ts, gid, _, _ = I.candidate_hits(scene, torch.tensor([origin],
                                                         dtype=torch.float32),
                                     torch.tensor([direction],
                                                  dtype=torch.float32))
    ts, gid = ts[0].numpy(), gid[0].numpy()
    order = np.argsort(ts, kind="stable")
    keep = np.isfinite(ts[order])
    return ts[order][keep], gid[order][keep]


def csg_scene(op):
    """csg.rs:233-267: sphere (left) op sphere translated (0, 0, 0.5)."""
    return build_scene([
        S.PointLight(position=(0, 0, 0)),
        S.Csg(op=op, left=S.Sphere(),
              right=S.Sphere(transform=tf.translation(0.0, 0.0, 0.5))),
    ], device="cpu")


@pytest.mark.parametrize("op,want_t,want_gid", [
    ("union", [4.0, 6.5], [0, 1]),
    ("intersect", [4.5, 6.0], [1, 0]),
    ("difference", [4.0, 4.5], [0, 1]),
])
def test_csg_filters(op, want_t, want_gid):
    ts, gid = hits(csg_scene(op), (0, 0, -5), (0, 0, 1))
    np.testing.assert_allclose(ts, want_t, atol=1e-4)
    assert gid.tolist() == want_gid


def test_csg_miss():
    ts, _ = hits(csg_scene("union"), (0, 2, -5), (0, 0, 1))
    assert ts.size == 0


def test_nested_csg():
    """(union of two spheres) minus a thin slab: the slab's faces become
    surface, the sphere hits inside the slab vanish."""
    sc = build_scene([
        S.PointLight(position=(0, 0, 0)),
        S.Csg("difference",
              S.Csg("union", S.Sphere(),
                    S.Sphere(transform=tf.translation(1.0, 0.0, 0.0))),
              S.Cube(transform=tf.Transform().scaling(2.0, 2.0, 0.2)
                     .translation(0.5, 0.0, 0.0).matrix)),
    ], device="cpu")
    ts, _ = hits(sc, (0.25, 0.0, -5.0), (0.0, 0.0, 1.0))
    np.testing.assert_allclose(ts, [4.03175, 4.8, 5.2, 5.96825], atol=1e-3)


def test_csg_sphere_cube_color():
    sc = build_scene([
        S.PointLight(position=(-10, 10, -10)),
        S.Csg("difference", S.Sphere(material=S.Material(color=(1, 0, 0))),
              S.Cube(transform=tf.Transform().scaling(0.5, 0.5, 0.5)
                     .translation(0.7, 0.0, -0.7).matrix)),
    ], device="cpu")
    col = R.color_at(sc, torch.tensor([[0.0, 0.0, -5.0]]),
                     torch.tensor([[0.0, 0.0, 1.0]]), limit=0)[0]
    assert col[0] > 0.5 and col[1] < 0.3


def _chain(n):
    """A left-leaning chain of n unions over n+1 disjoint spheres on x."""
    tree = S.Sphere()
    for i in range(n):
        tree = S.Csg("union", tree, S.Sphere(
            transform=tf.translation(3.0 * (i + 1), 0.0, 0.0)))
    return tree


def test_csg_64_nodes_builds_and_filters():
    sc = build_scene([S.PointLight(position=(0, 0, 0)), _chain(64)],
                     device="cpu")
    assert len(sc.static.csg_nodes) == 64
    assert max(u for _, u, _ in sc.static.csg_members) >> 63 == 1
    for k in (0, 1, 63, 64):
        ts, _ = hits(sc, (3.0 * k, 0.0, -5.0), (0.0, 0.0, 1.0))
        np.testing.assert_allclose(ts, [4.0, 6.0], atol=1e-4)
    with pytest.raises(ValueError, match="64 CSG nodes"):
        build_scene([S.PointLight(position=(0, 0, 0)), S.Csg(
            "union", _chain(64), S.Sphere())], device="cpu")


def test_pairwise_filter_matches_sorted_with_ties():
    nodes = [(T.CSG_UNION, 2, 0), (T.CSG_INTERSECT, 1, 0),
             (T.CSG_DIFFERENCE, 0, 0)]
    under = np.array([0b111, 0b111, 0b101, 0b101, 0b011, 0b011, 0b001,
                      0b001], np.uint64)
    left = np.array([0b110, 0b010, 0b100, 0b000, 0b011, 0b001, 0b001,
                     0b000], np.uint64)
    rng = np.random.default_rng(7)
    for _ in range(5):
        ts = rng.normal(size=(64, 8)).astype(np.float32)
        ts[ts > 1.0] = np.inf
        ts[:, 3] = ts[:, 1]          # an exact duplicate column: a t-tie
        sub = torch.as_tensor(ts)
        plan = CSG._node_plan(nodes, under, left, sub.device)
        got_p = CSG._filter_pairwise(sub, plan)
        got_s = CSG._filter_sorted(sub, plan)
        assert torch.equal(got_p, got_s)
        want = np.asarray(JCSG._filter_pairwise(jnp.asarray(ts), nodes,
                                                under, left))
        np.testing.assert_array_equal(got_p.numpy(), want)


def _examples_csg_tree():
    """examples/csg.py's tree."""
    outer = S.Csg("intersect", S.Sphere(transform=tf.scaling(1.3, 1.3, 1.3)),
                  S.Cube(transform=tf.rotation_y(PI / 3)))
    cyl = [S.Cylinder(transform=tf.Transform().scaling(0.6, 0.6, 0.6)
                      ._apply(m).rotation_y(PI / 3).matrix,
                      material=S.Material(color=c))
           for m, c in ((np.eye(4), (1, 0, 0)),
                        (tf.rotation_x(PI / 2), (0, 0, 1)),
                        (tf.rotation_z(PI / 2), (0, 1, 0)))]
    inner = S.Csg("union", S.Csg("union", cyl[0], cyl[1]), cyl[2])
    return S.Csg("difference", outer, inner)


@pytest.mark.parametrize("tree,path", [
    ("examples_csg", "pairwise"), ("chain_64", "sorted")])
def test_apply_csg_matches_jax(tree, path):
    """apply_csg on random tables (negatives, +inf, t-ties) with the
    columns of a real tree: the examples' tree (16 columns, the pairwise
    path) and the 64-node chain (130 columns, the sorted path)."""
    root = _examples_csg_tree() if tree == "examples_csg" else _chain(64)
    js, ps = same_tables([S.PointLight(position=(0, 5, -5)), S.Plane(),
                          root])
    obj, _, c_static = I.candidate_meta(ps.static)
    gids = obj[:c_static]
    assert (c_static <= CSG.PAIRWISE_MAX_COLS) == (path == "pairwise")
    rng = np.random.default_rng(3)
    ts = rng.normal(0, 3, (96, c_static)).astype(np.float32)
    ts[rng.uniform(size=ts.shape) < 0.3] = np.inf
    ts[:, 5] = ts[:, 2]
    got = CSG.apply_csg(ps, torch.as_tensor(ts), gids, c_static)
    want = JCSG.apply_csg(js, jnp.asarray(ts), gids, c_static)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isinf(got.numpy()).sum() > np.isinf(ts).sum()


def test_csg_area_light_shadow_matches_bruteforce():
    """shadow_blocked's CSG path (quadric columns + apply_csg on the
    flattened [R*S, C] table) against one generic nearest_hit per
    flattened shadow ray, the nearest positive hit's flag deciding; and
    against the JAX package's shadow_blocked."""
    items = [
        S.AreaLight(corner=(-1.0, 4.0, -1.0), uvec=(2.0, 0.0, 0.0), usteps=3,
                    vvec=(0.0, 0.0, 2.0), vsteps=3),
        S.Plane(material=S.Material(specular=0.0)),
        S.Csg("difference", S.Sphere(transform=tf.translation(0.0, 1.5, 0.0)),
              S.Cube(transform=tf.Transform().scaling(0.6, 0.6, 0.6)
                     .translation(0.7, 1.9, -0.4).matrix)),
        S.Csg("intersect",
              S.Sphere(transform=tf.translation(-2.0, 1.2, 1.0), shadow=False),
              S.Cube(transform=tf.Transform().scaling(0.8, 0.8, 0.8)
                     .translation(-2.0, 1.2, 1.0).matrix, shadow=False)),
    ]
    js, sc = same_tables(items, jitter=(0.5,))
    xs = np.linspace(-3.0, 3.0, 9, dtype=np.float32)
    zs = np.linspace(-2.0, 2.0, 5, dtype=np.float32)
    pts = np.array([[x, 1e-3, z] for x in xs for z in zs], np.float32)
    r = pts.shape[0]
    corner = np.array([-1.0, 4.0, -1.0], np.float32)
    uvec = np.array([2.0, 0.0, 0.0], np.float32) / 3
    vvec = np.array([0.0, 0.0, 2.0], np.float32) / 3
    samples = np.array([corner + (u + 0.5) * uvec + (v + 0.5) * vvec
                        for u in range(3) for v in range(3)], np.float32)
    pos = np.broadcast_to(samples[None], (r, 9, 3))

    got = I.shadow_blocked(sc, torch.as_tensor(pts),
                           torch.as_tensor(pos.copy())).numpy()

    v = pos - pts[:, None]
    dist = np.linalg.norm(v, axis=-1)
    dirs = (v / dist[..., None]).reshape(-1, 3)
    flat_o = np.broadcast_to(pts[:, None], (r, 9, 3)).reshape(-1, 3)
    has, t, g, _, _ = I.nearest_hit(sc, torch.as_tensor(flat_o.copy()),
                                    torch.as_tensor(dirs))
    flag = sc.shadow[I.transform_row(sc, g.long())]
    ref = (has & (t < torch.as_tensor(dist.reshape(-1))) & flag).numpy()
    np.testing.assert_array_equal(got, ref.reshape(r, 9))
    assert got.any() and not got.all()
    jgot = JI.shadow_blocked(js, jnp.asarray(pts), jnp.asarray(pos))
    np.testing.assert_array_equal(got, np.asarray(jgot))


# ----------------------------------------------------------- area lights

def test_area_light_deterministic_intensity():
    """lights.rs:203-229 via shadowed: with jitter 0.5 the samples are
    cell centres; (0,0,2) is fully shadowed, (0,0,-2) fully lit."""
    sc = build_scene([
        S.AreaLight(corner=(-0.5, -0.5, -5.0), uvec=(1.0, 0.0, 0.0), usteps=2,
                    vvec=(0.0, 1.0, 0.0), vsteps=2),
        S.Sphere(material=S.Material(color=(0.8, 1.0, 0.6), diffuse=0.7,
                                     specular=0.2)),
        S.Sphere(transform=tf.scaling(0.5, 0.5, 0.5)),
    ], jitter=(0.5,), device="cpu")
    corner = np.array([-0.5, -0.5, -5.0])
    pts = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, -2.0]])
    frac = np.zeros(2)
    for u in range(2):
        for v in range(2):
            c = corner + np.array([0.5 * (u + 0.5), 0.5 * (v + 0.5), 0.0])
            frac += ~R.shadowed(sc, pts, c.astype(np.float32)).numpy()
    assert (frac / 4).tolist() == [0.0, 1.0]


@pytest.mark.parametrize("pt,expected", [
    ((0.0, 0.0, -1.0), 0.9965), ((0.0, 0.7071, -0.7071), 0.6232)])
def test_area_light_lighting_oracle(pt, expected):
    """materials.rs:283-317 through color_at: a 2x2 light with jitter
    0.5, no shadow."""
    sc = build_scene([
        S.AreaLight(corner=(-0.5, -0.5, -5.0), uvec=(1.0, 0.0, 0.0), usteps=2,
                    vvec=(0.0, 1.0, 0.0), vsteps=2),
        S.Sphere(material=S.Material(ambient=0.1, diffuse=0.9, specular=0.0)),
    ], jitter=(0.5,), device="cpu")
    eye = np.array([0.0, 0.0, -5.0], np.float32)
    d = np.asarray(pt, np.float32) - eye
    d /= np.linalg.norm(d)
    got = R.color_at(sc, torch.as_tensor(eye[None]),
                     torch.as_tensor(d[None]), limit=0)
    np.testing.assert_allclose(got[0].numpy(), expected, atol=2e-3)


def test_det_jitter_cycle_property():
    """The deterministic tables against a direct simulation of the
    reference's one cycling iterator (lights.rs:77-121): per shading
    point, intensity_at draws (u, v) per sample in u-major order, then the
    lighting pass 2 more per sample, continuing across area lights."""
    import itertools

    def rust_cycle(seq, lights_steps):
        it = itertools.cycle(seq)
        out = []
        for us, vs in lights_steps:
            s = us * vs
            out.append(([(next(it), next(it)) for _ in range(s)],
                        [(next(it), next(it)) for _ in range(s)]))
        return out

    seqs = [tuple((i + 1) / (n + 1) for i in range(n)) for n in range(1, 6)]
    grids = [[(1, 1)], [(2, 2)], [(3, 2)], [(2, 3), (1, 4)], [(5, 1), (2, 2)]]
    for seq in seqs:
        st = T.SceneStatic(counts=(0,) * 6, jitter=seq)
        for steps in grids:
            phase = 0
            for (us, vs), (exp_int, exp_lit) in zip(steps,
                                                    rust_cycle(seq, steps)):
                ju1, jv1, ju2, jv2 = R._det_jitter_tables(st, us * vs, phase)
                np.testing.assert_allclose(list(zip(ju1, jv1)), exp_int)
                np.testing.assert_allclose(list(zip(ju2, jv2)), exp_lit)
                phase += 4 * us * vs


@pytest.mark.parametrize("seq", [(0.5,), (0.7, 0.3, 0.9, 0.1, 0.5),
                                 (0.001,), (0.25, 0.75)])
@pytest.mark.parametrize("s_total,phase", [(1, 0), (4, 0), (100, 0),
                                           (6, 24)])
def test_det_jitter_tables_equal_jax(seq, s_total, phase):
    st = T.SceneStatic(counts=(0,) * 6, jitter=seq)
    for got, want in zip(R._det_jitter_tables(st, s_total, phase),
                         JR._det_jitter_tables(st, s_total, phase)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- frames

def _u8_budget(got, want, label):
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    print(f"{label}: {int((diff > 0).sum())} of {diff.size} pixels differ, "
          f"{int((diff > 1).sum())} by more than 1 step, max {diff.max()}")
    assert (diff > 1).mean() <= 0.005
    return diff


def _mesh_area_items(hsize=32, vsize=24):
    """glass_mesh(2) with its point light replaced by a 3x3 area light."""
    items, cam = scenes.glass_mesh(2, hsize=hsize, vsize=vsize)
    items[0] = S.AreaLight(corner=(-11.0, 20.0, -11.0), uvec=(2.0, 0.0, 0.0),
                           usteps=3, vvec=(0.0, 0.0, 2.0), vsteps=3)
    return items, cam


def test_area_light_over_mesh_frame_matches_jax():
    """Area light over transparent meshes (the any-hit shadow query in
    the R x S layout, the behind column), deterministic jitter."""
    items, cam = _mesh_area_items()
    js, ps = same_tables(items, jitter=(0.5,))
    want = JR.render(js, jax_camera(cam), quantize=True)
    got = R.render(ps, cam, quantize=True)
    _u8_budget(got, want, "mesh x area light")
    assert want.std() > 5


def test_csg_area_light_frame_matches_jax():
    """scenes.csg_area_yaml at 48x27 through both parsers and renderers,
    deterministic jitter; the tables too."""
    text = scenes.csg_area_yaml(48, 27)
    jcam, js = jax_parse_scene(text, jitter=(0.5,))
    cam, ps = parse_scene(text, jitter=(0.5,), device="cpu")
    assert_same_tables(js, ps)
    want = JR.render(js, jcam, quantize=True)
    got = R.render(ps, cam, quantize=True)
    _u8_budget(got, want, "csg x area light")
    assert want.std() > 1


def _seeded_scene():
    """A CSG tree on a floor under a 5x5 area light (a soft shadow)."""
    items = [S.AreaLight(corner=(-1.5, 4.0, -1.5), uvec=(3.0, 0.0, 0.0),
                         usteps=5, vvec=(0.0, 0.0, 3.0), vsteps=5),
             S.Plane(material=S.Material(specular=0.0)),
             S.Csg("difference",
                   S.Sphere(transform=tf.translation(0.0, 1.0, 0.0)),
                   S.Cube(transform=tf.Transform().scaling(0.5, 0.5, 0.5)
                          .translation(0.6, 1.4, -0.6).matrix))]
    cam = Camera(48, 32, PI / 3).with_transform(
        tf.view_transform((0.0, 3.0, -5.0), (0.0, 0.5, 0.0), (0, 1, 0)))
    return items, cam


def test_seeded_area_light_same_seed_same_bytes():
    items, cam = _seeded_scene()
    sc = build_scene(items, device="cpu")
    a = R.render(sc, cam, quantize=True)
    b = R.render(sc, cam, quantize=True)
    g = torch.Generator().manual_seed(0)
    c = R.render(sc, cam, quantize=True, generator=g)
    assert np.array_equal(a, b) and np.array_equal(a, c)
    d = R.render(sc, cam, quantize=True,
                 generator=torch.Generator().manual_seed(1))
    assert not np.array_equal(a, d)


def test_seeded_area_light_matches_jax_statistically():
    """Port and JAX seeded frames (different streams): means within 0.5
    u8 step; of the pixels more than one step apart, at most 0.5% of the
    frame lies outside the penumbra (see the module docstring)."""
    items, cam = _seeded_scene()
    js, ps = same_tables(items)
    want = JR.render(js, jax_camera(cam), key=jax.random.PRNGKey(0),
                     quantize=True)
    got = R.render(ps, cam, quantize=True)
    assert abs(float(got.mean()) - float(want.mean())) <= 0.5
    corners = []
    for seq in ((0.001,), (0.999,), (0.001, 0.999), (0.999, 0.001)):
        _, pj = same_tables(items, jitter=seq)
        corners.append(R.render(pj, cam, quantize=True).astype(int))
    penumbra = (np.ptp(np.stack(corners), axis=0) > 0).any(-1)
    far = np.abs(got.astype(int) - want.astype(int)).max(-1) > 1
    print(f"seeded: means {got.mean():.3f} / {want.mean():.3f}; "
          f"{int(far.sum())} pixels > 1 step apart, "
          f"{int((far & ~penumbra).sum())} outside the penumbra "
          f"({int(penumbra.sum())} pixels)")
    assert penumbra.mean() > 0.01           # the scene has a soft shadow
    assert (far & ~penumbra).mean() <= 0.005
