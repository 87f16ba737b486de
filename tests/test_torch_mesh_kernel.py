"""Mesh kernel K1 of raytracer_tpu_torch (ops/mesh_cuda.py): its plain
PyTorch version against the JAX package's Pallas kernel run in interpret
mode, on the same packed tables, in all three modes (nearest, any-hit,
reversed rays), with caps and per-triangle det thresholds; and the
pre-pass (K1b) and plane packer (K1c) against their JAX originals.

Tolerances: t to rtol 1e-5 with np.allclose's atol 1e-8, as
tests/test_pallas.py holds the Pallas kernel (both evaluate
Moller-Trumbore in the same order of f32 operations, but XLA may contract
a multiply-add, which shows as a relative error on t near 0); u and v to
1e-4 absolute; the triangle index on >= 99.9% of hits (exact t ties between triangles of different chunks may resolve differently,
since the Pallas kernel visits supergroups by entry distance and the plain
version in index order; the port's rule is the lowest index, tested
alone), hit existence and any-hit verdicts exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.ops import mesh_pallas as MP
from raytracer_tpu_torch import mesh_cases
from raytracer_tpu_torch.ops import mesh_cuda as MC


def _soup(rng, nt, lo=-3, hi=3, scale=0.5):
    p1 = rng.uniform(lo, hi, (nt, 3)).astype(np.float32)
    e1 = rng.normal(0, scale, (nt, 3)).astype(np.float32)
    e2 = rng.normal(0, scale, (nt, 3)).astype(np.float32)
    return p1, e1, e2


def _rays(rng, r=MC.RT, center=(0, 0, -8.0), aim=(0, 0, 3.0), spread=1.0):
    o = (rng.uniform(-spread, spread, (r, 3)) + np.asarray(center)).astype(
        np.float32)
    d = rng.normal(0, 1, (r, 3)) + np.asarray(aim)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _both(p1, e1, e2, o, d, det_eps=None, t_init=None, any_hit=False,
          reverse=False):
    """(JAX interpret result, port plain result) as numpy 4-tuples."""
    tri, bb = MP.pack_tri_planes_np(p1, e1, e2, det_eps)
    jd = -d if reverse else d
    jr = MP.mesh_nearest(
        jnp.asarray(o), jnp.asarray(jd), jnp.asarray(tri),
        (jnp.asarray(bb[0]), jnp.asarray(bb[1])),
        t_init=None if t_init is None else jnp.asarray(t_init),
        any_hit=any_hit, interpret=True)
    ptri, pbb = MC.pack_tri_planes_np(p1, e1, e2, det_eps)
    pr = MC.mesh_nearest_plain(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(ptri),
        (torch.as_tensor(pbb[0]), torch.as_tensor(pbb[1])),
        t_init=None if t_init is None else torch.as_tensor(t_init),
        any_hit=any_hit, reverse=reverse)
    return [np.asarray(x) for x in jr], [x.numpy() for x in pr]


def _assert_nearest_agrees(jr, pr, min_hits=20):
    (jt, jg, ju, jv), (pt, pg, pu, pv) = jr, pr
    hit = np.isfinite(jt)
    assert hit.sum() >= min_hits
    assert (np.isfinite(pt) == hit).all()
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=1e-5, atol=1e-8)
    assert (pg[hit] == jg[hit]).mean() >= 0.999
    # u, v = numerator / det: an ulp of det is amplified by 1/|det| on
    # grazing triangles, hence a looser absolute bound than t's
    same = hit & (pg == jg)
    np.testing.assert_allclose(pu[same], ju[same], atol=1e-4)
    np.testing.assert_allclose(pv[same], jv[same], atol=1e-4)


@pytest.mark.parametrize("nt", [70, 700])
def test_plain_matches_pallas_random_soup(nt):
    rng = np.random.default_rng(1)
    p1, e1, e2 = _soup(rng, nt)
    o, d = _rays(rng)
    _assert_nearest_agrees(*_both(p1, e1, e2, o, d))


def test_plain_matches_pallas_multi_supergroup_caps_any_hit():
    """20,000 depth-sorted triangles = 3 supergroups (the early-exit
    path), then mixed caps, any-hit capped and uncapped."""
    rng = np.random.default_rng(9)
    nt = 20000
    c = rng.uniform(-3, 3, (nt, 3))
    c[:, 2] = np.sort(rng.uniform(0, 30, nt))
    p1 = (c + rng.normal(0, 0.1, (nt, 3))).astype(np.float32)
    e1 = rng.normal(0, 0.2, (nt, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.2, (nt, 3)).astype(np.float32)
    o = (rng.uniform(-2, 2, (MC.RT, 3)) * np.array([1, 1, 0])
         + np.array([0, 0, -5.0])).astype(np.float32)
    d = rng.normal(0, 0.15, (MC.RT, 3)) + np.array([0, 0, 1.0])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    assert MC.pack_tri_planes_np(p1, e1, e2)[0].shape[0] == 3

    jr, pr = _both(p1, e1, e2, o, d)
    _assert_nearest_agrees(jr, pr, min_hits=100)

    t_ref = jr[0]
    hit = np.isfinite(t_ref)
    cap = np.where(hit, t_ref, 40.0).astype(np.float32)
    cap[0::2] *= 0.5
    cap[1::2] *= 1.5
    cap[2::8] = np.inf
    jr_c, pr_c = _both(p1, e1, e2, o, d, t_init=cap)
    kept = t_ref < cap
    assert kept.sum() > 20 and (~kept).sum() > 20
    _assert_nearest_agrees(jr_c, pr_c)
    assert not np.isfinite(pr_c[0][~kept]).any()

    for t_init, found in ((cap, kept), (None, hit)):
        jr_a, pr_a = _both(p1, e1, e2, o, d, t_init=t_init, any_hit=True)
        for t in (jr_a[0], pr_a[0]):
            assert (t[found] == 0.0).all()
            assert not np.isfinite(t[~found]).any()


def test_plain_matches_pallas_reversed_rays():
    """The behind query: nearest hit of (o, -d), from inside the soup so
    both signs of t occur."""
    rng = np.random.default_rng(3)
    p1, e1, e2 = _soup(rng, 700)
    o = rng.uniform(-2, 2, (MC.RT, 3)).astype(np.float32)
    d = rng.normal(0, 1, (MC.RT, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jr, pr = _both(p1, e1, e2, o, d, reverse=True)
    _assert_nearest_agrees(jr, pr, min_hits=50)


def test_plain_matches_pallas_per_triangle_det_eps():
    """Tiny triangles (|e1 x e2| ~ 1e-5) pass their own threshold and are
    hit; the unit threshold rejects almost all of them — in both."""
    rng = np.random.default_rng(3)
    nt, s = 70, 0.004
    p1 = rng.uniform(-0.02, 0.02, (nt, 3)).astype(np.float32)
    e1 = rng.normal(0, s, (nt, 3)).astype(np.float32)
    e2 = rng.normal(0, s, (nt, 3)).astype(np.float32)
    o = (rng.uniform(-0.01, 0.01, (MC.RT, 3))
         + np.array([0, 0, -1.0])).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (MC.RT, 1))
    deps = np.full(nt, 1e-12, np.float32)
    jr, pr = _both(p1, e1, e2, o, d, det_eps=deps)
    _assert_nearest_agrees(jr, pr, min_hits=10)
    jr0, pr0 = _both(p1, e1, e2, o, d)
    assert (np.isfinite(pr0[0]) == np.isfinite(jr0[0])).all()
    assert np.isfinite(pr0[0]).sum() < np.isfinite(pr[0]).sum() / 4


def test_pack_tri_planes_matches_jax():
    rng = np.random.default_rng(4)
    for nt in (5, 1024, 9000):
        p1, e1, e2 = _soup(rng, nt)
        deps = rng.uniform(1e-6, 1e-4, nt).astype(np.float32)
        for de in (None, deps):
            jt, (jc, js) = MP.pack_tri_planes_np(p1, e1, e2, de)
            pt, (pc, ps) = MC.pack_tri_planes_np(p1, e1, e2, de)
            for a, b in ((jt, pt), (jc, pc), (js, ps)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_live_supergroups_matches_jax():
    """K1b: same live ids (stable front-to-back order), counts and sorted
    entry distances as the JAX pre-pass, capped and uncapped."""
    rng = np.random.default_rng(6)
    nt = 40000
    c = rng.uniform(-3, 3, (nt, 3))
    c[:, 2] = np.sort(rng.uniform(0, 30, nt))
    p1 = (c + rng.normal(0, 0.1, (nt, 3))).astype(np.float32)
    e1, e2 = (rng.normal(0, 0.2, (nt, 3)).astype(np.float32) for _ in "ab")
    o, d = _rays(rng, r=4 * MC.RT, center=(0, 0, -5.0), aim=(0, 0, 6.0),
                 spread=3.0)
    _, (bbc, bbs) = MC.pack_tri_planes_np(p1, e1, e2)
    cap = rng.uniform(0, 30, 4 * MC.RT).astype(np.float32)
    for t_cap in (None, cap):
        jinv = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, jnp.asarray(d))
        j = MP._live_supergroups(
            jnp.asarray(o), jinv, jnp.asarray(bbs),
            None if t_cap is None else jnp.asarray(t_cap))
        tinv = MC.inverse_dirs(torch.as_tensor(d))
        np.testing.assert_array_equal(np.asarray(jinv), tinv.numpy())
        p = MC.live_supergroups(
            torch.as_tensor(o), tinv, torch.as_tensor(bbs),
            None if t_cap is None else torch.as_tensor(t_cap))
        for a, b in zip(j, p):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert 0 < int(p[1].min()) and int(p[1].max()) <= bbs.shape[1]


@pytest.mark.parametrize("capped", [False, True], ids=["uncapped", "capped"])
@pytest.mark.parametrize("n_super", mesh_cases.PREPASS_SUPERS)
def test_live_supergroups_cases_match_jax(n_super, capped):
    """K1b's plain version against the JAX pre-pass on boxes alone
    (mesh_cases.prepass_case) at the supergroup counts the kernel must
    cover: a subtile that misses every box (count 0), boxes with tied
    entries (ordered by id), origins inside a box (entry 0, and -0 from a
    slab), capped and uncapped. ids and counts exactly, entries equal as
    floats (-0 == +0)."""
    c = mesh_cases.prepass_case(n_super)
    cap = c["t_init"] if capped else None
    jinv = 1.0 / jnp.where(jnp.abs(c["d"]) < 1e-12, 1e-12,
                           jnp.asarray(c["d"]))
    j = MP._live_supergroups(jnp.asarray(c["o"]), jinv,
                             jnp.asarray(c["bb_super"]),
                             None if cap is None else jnp.asarray(cap))
    p = MC.live_supergroups_plain(
        torch.as_tensor(c["o"]), MC.inverse_dirs(torch.as_tensor(c["d"])),
        torch.as_tensor(c["bb_super"]),
        None if cap is None else torch.as_tensor(cap))
    for a, b in zip(j, p):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ids, cnt, ent = (x.numpy() for x in p)
    assert cnt[0] > 0 and cnt[1] == 0
    assert np.isinf(ent[1]).all() and (ids[1] == np.arange(n_super)).all()
    assert ent[0][0] == 0.0 and (np.diff(ent[0][:cnt[0]]) >= 0).all()
    tied = np.flatnonzero(np.diff(ent[0][:cnt[0]]) == 0)
    assert (ids[0][tied] < ids[0][tied + 1]).all()
    if n_super >= 7:
        assert len(tied) > 0


def _plain(c, **kw):
    tri, bb = MC.pack_tri_planes_np(c["p1"], c["e1"], c["e2"])
    return MC.mesh_nearest_plain(
        torch.as_tensor(c["o"]), torch.as_tensor(c["d"]),
        torch.as_tensor(tri), tuple(torch.as_tensor(x) for x in bb), **kw)


def test_padding_chunks_are_never_live():
    """A last supergroup of 1,664 real triangles and 6 padding chunks (as
    glass_mesh's): the padding chunks' boxes are empty, and rays aimed away
    from every real triangle pass no gate at all (before the empty-box
    test, each padding chunk counted rays x 1024 tests)."""
    away = mesh_cases.padding_case(through=False)
    _, (bbc, _) = MC.pack_tri_planes_np(away["p1"], away["e1"], away["e2"])
    assert bbc.shape[1] == 16
    assert (bbc[:3, -6:] > bbc[3:, -6:]).all()
    assert (bbc[:3, :-6] <= bbc[3:, :-6]).all()
    *_, tests = _plain(away, count_tests=True)
    assert tests == {"ray": 0, "warp": 0, "block": 0}


def test_padding_case_rays_through_match_pallas():
    c = mesh_cases.padding_case(through=True)
    jr, pr = _both(c["p1"], c["e1"], c["e2"], c["o"], c["d"])
    _assert_nearest_agrees(jr, pr, min_hits=100)
    *_, tests = _plain(c, count_tests=True)
    assert 0 < tests["ray"] <= tests["warp"] <= tests["block"]
    assert tests["ray"] <= 256 * 10 * MC.CHUNK


def test_exact_tie_lowest_index_wins():
    """One triangle at three indices in three supergroups: every ray hits
    all three at the same t, and the plain version returns the lowest
    index (the rule the kernel's merge word keeps)."""
    c = mesh_cases.tie_case()
    t, idx, u, v = _plain(c)
    assert torch.isfinite(t).all()
    assert (idx == mesh_cases.TIE_INDEX).all()
    np.testing.assert_array_equal(t.numpy(), np.float32(5.0))
    tri, bb = MC.pack_tri_planes_np(c["p1"], c["e1"], c["e2"])
    assert tri.shape[0] == 3


def test_mesh_nearest_cpu_takes_plain_and_counts_no_launch():
    rng = np.random.default_rng(2)
    p1, e1, e2 = _soup(rng, 300)
    o, d = _rays(rng)
    tri, bb = MC.pack_tri_planes_np(p1, e1, e2)
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tri),
            tuple(torch.as_tensor(x) for x in bb))
    before = MC.mesh_nearest.launches, MC.live_supergroups.launches
    for kw in ({}, {"any_hit": True}, {"reverse": True}):
        a = MC.mesh_nearest(*args, **kw)
        b = MC.mesh_nearest_plain(*args, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    inv = MC.inverse_dirs(args[1])
    for x, y in zip(MC.live_supergroups(args[0], inv, args[3][1]),
                    MC.live_supergroups_plain(args[0], inv, args[3][1])):
        assert torch.equal(x, y)
    assert (MC.mesh_nearest.launches, MC.live_supergroups.launches) == before


def test_mesh_nearest_rejects_bad_inputs():
    rng = np.random.default_rng(2)
    p1, e1, e2 = _soup(rng, 30)
    tri, bb = MC.pack_tri_planes_np(p1, e1, e2)
    tri, bb = torch.as_tensor(tri), tuple(torch.as_tensor(x) for x in bb)
    o, d = (torch.as_tensor(x) for x in _rays(rng))
    with pytest.raises(ValueError, match="multiple"):
        MC.mesh_nearest(o[:100], d[:100], tri, bb)
    with pytest.raises(ValueError, match="f32"):
        MC.mesh_nearest(o.double(), d, tri, bb)
    with pytest.raises(ValueError, match="t_init"):
        MC.mesh_nearest(o, d, tri, bb, t_init=torch.zeros(3))
    with pytest.raises(ValueError, match="contiguous"):
        MC.mesh_nearest(o, d.T.contiguous().T, tri, bb)
