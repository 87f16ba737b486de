"""raytracer_tpu_torch on the card: the CUDA mesh kernel against its plain
version, a frame rendered on cuda against the same frame on the CPU, and
the mesh query's gradient and a render loss's gradients on cuda against
the CPU; table_gather's kernels against their plain versions, captured in
a graph, and in a flagship train step graphed against eager.

Every test here carries the ``cuda`` marker and skips itself when there is
no CUDA device. The file imports neither JAX nor the JAX package, so on a
machine with a card and without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import mesh_cases, scenes
from raytracer_tpu_torch.core.render import render
from raytracer_tpu_torch.ops import mesh_cuda as MC
from raytracer_tpu_torch.scene import build_scene


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nearest", "any_hit", "behind"])
def test_kernel_matches_plain(mode):
    """All three modes on a 20,000-triangle, 3-supergroup soup with caps:
    t to rtol 1e-5, index on >= 99.9% of hits, existence exact."""
    _require_cuda()
    rng = np.random.default_rng(9)
    nt, r = 20000, 4 * MC.RT
    c = rng.uniform(-3, 3, (nt, 3))
    c[:, 2] = np.sort(rng.uniform(0, 30, nt))
    p1 = (c + rng.normal(0, 0.1, (nt, 3))).astype(np.float32)
    e1, e2 = (rng.normal(0, 0.2, (nt, 3)).astype(np.float32) for _ in "ab")
    o = (rng.uniform(-2, 2, (r, 3)) + np.array([0, 0, 10.0])).astype(
        np.float32)
    d = rng.normal(0, 0.3, (r, 3)) + np.array([0, 0, 1.0])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cap = rng.uniform(1, 30, r).astype(np.float32)
    cap[::3] = np.inf
    tri, bb = MC.pack_tri_planes_np(p1, e1, e2)
    cu = lambda x: torch.as_tensor(x, device="cuda")  # noqa: E731
    args = (cu(o), cu(d), cu(tri), (cu(bb[0]), cu(bb[1])))
    kw = dict(t_init=cu(cap), any_hit=mode == "any_hit",
              reverse=mode == "behind")
    before = MC.mesh_nearest.launches
    k = [x.cpu().numpy() for x in MC.mesh_nearest(*args, **kw)]
    torch.cuda.synchronize()
    assert MC.mesh_nearest.launches == before + 1
    p = [x.cpu().numpy() for x in MC.mesh_nearest_plain(*args, **kw)]
    hit = np.isfinite(p[0])
    assert hit.sum() > 50
    assert (np.isfinite(k[0]) == hit).all()
    np.testing.assert_allclose(k[0][hit], p[0][hit], rtol=1e-5, atol=1e-8)
    if mode != "any_hit":
        assert (k[1][hit] == p[1][hit]).mean() >= 0.999


def _on_card(c):
    tri, bb = MC.pack_tri_planes_np(c["p1"], c["e1"], c["e2"])
    cu = lambda x: torch.as_tensor(x, device="cuda")  # noqa: E731
    t0 = c.get("t_init")
    return ((cu(c["o"]), cu(c["d"]), cu(tri), (cu(bb[0]), cu(bb[1]))),
            None if t0 is None else cu(t0))


def _kernel_vs_plain(args, idx_min=0.999, **kw):
    before = MC.mesh_nearest.launches, MC.live_supergroups.launches
    k = [x.cpu().numpy() for x in MC.mesh_nearest(*args, **kw)]
    torch.cuda.synchronize()
    assert (MC.mesh_nearest.launches, MC.live_supergroups.launches) == (
        before[0] + 1, before[1] + 1)
    p = [x.cpu().numpy() for x in MC.mesh_nearest_plain(*args, **kw)]
    hit = np.isfinite(p[0])
    assert (np.isfinite(k[0]) == hit).all()
    np.testing.assert_allclose(k[0][hit], p[0][hit], rtol=1e-5, atol=1e-8)
    if kw.get("any_hit"):
        assert (k[0][hit] == 0.0).all()
    elif hit.any():
        assert (k[1][hit] == p[1][hit]).mean() >= idx_min
    return k, p


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nearest", "any_hit", "behind"])
@pytest.mark.parametrize("rays", [256, 16384, 65536])
def test_kernel_matches_plain_at_slice_extremes(rays, mode):
    """256 rays (one subtile: the most slices, 64), 16,384 rays (a
    main-path tile, 64 slices) and 65,536 rays (16 slices), the
    3-supergroup stream with mixed caps, all three modes."""
    _require_cuda()
    assert MC.walk_slices(rays) == {256: 64, 16384: 64, 65536: 16}[rays]
    args, cap = _on_card(mesh_cases.stream_case(rays))
    _, p = _kernel_vs_plain(args, t_init=cap, any_hit=mode == "any_hit",
                            reverse=mode == "behind")
    assert np.isfinite(p[0]).sum() > rays // 10


@pytest.mark.cuda
def test_kernel_exact_tie_takes_lowest_index():
    """One triangle at three indices in three supergroups (two slices):
    the kernel returns the lowest index on 100% of hits."""
    _require_cuda()
    args, _ = _on_card(mesh_cases.tie_case())
    k, p = _kernel_vs_plain(args, idx_min=1.0)
    assert np.isfinite(k[0]).all()
    assert (k[1] == mesh_cases.TIE_INDEX).all()


@pytest.mark.cuda
def test_kernel_any_hit_from_inside_chunk_boxes():
    """Shadow rays that start on the mesh, inside chunk boxes (slab tmin <
    0), capped: any-hit verdicts equal the plain version's exactly."""
    _require_cuda()
    args, cap = _on_card(mesh_cases.inside_boxes_case())
    _, p = _kernel_vs_plain(args, t_init=cap, any_hit=True)
    found = np.isfinite(p[0])
    assert 0.05 < found.mean() < 0.95


@pytest.mark.cuda
def test_prepass_kernel_equals_torch_version():
    """K1b's kernel gives exactly live_supergroups_plain's ids, counts and
    entries, capped and uncapped."""
    _require_cuda()
    c = mesh_cases.stream_case(4096)
    (o, d, _, bb), cap = _on_card(c)
    inv = MC.inverse_dirs(d)
    for t_cap in (None, cap):
        k = MC.live_supergroups(o, inv, bb[1], t_cap)
        p = MC.live_supergroups_plain(o, inv, bb[1], t_cap)
        for x, y in zip(k, p):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n_super", [*mesh_cases.PREPASS_SUPERS, 5811,
                                     MC.PREPASS_SUPER_MAX])
def test_prepass_kernel_cases_equal_torch_version(n_super):
    """K1b's kernel against live_supergroups_plain on boxes alone
    (mesh_cases.prepass_case: a subtile that misses everything, tied
    entries, origins inside a box), capped and uncapped, at the CPU
    cases' supergroup counts, at 5,811 (the most the first design's
    shared memory took) and at PREPASS_SUPER_MAX: ids, counts and entries
    equal, and entries bit-equal but for -0 keyed as +0."""
    _require_cuda()
    c = mesh_cases.prepass_case(n_super)
    o, d, bb, cap = (torch.as_tensor(c[k], device="cuda")
                     for k in ("o", "d", "bb_super", "t_init"))
    inv = MC.inverse_dirs(d)
    for t_cap in (None, cap):
        before = MC.live_supergroups.launches
        k = MC.live_supergroups(o, inv, bb, t_cap)
        torch.cuda.synchronize()
        assert MC.live_supergroups.launches == before + 1
        p = MC.live_supergroups_plain(o, inv, bb, t_cap)
        for x, y in zip(k, p):
            assert torch.equal(x, y)
        assert torch.equal(k[2].view(torch.int32),
                           (p[2] + 0.0).view(torch.int32))
        assert int(k[1][1]) == 0


@pytest.mark.cuda
def test_cuda_frame_matches_cpu_frame():
    """glass_mesh (all three kernel modes) on cuda and on the CPU: at most
    0.5% of pixels more than one u8 step apart."""
    _require_cuda()
    items, cam = scenes.glass_mesh(instances=4, hsize=96, vsize=54)
    before = MC.mesh_nearest.launches
    gpu = render(build_scene(items, device="cuda"), cam, quantize=True)
    assert MC.mesh_nearest.launches > before
    cpu = render(build_scene(items, device="cpu"), cam, quantize=True)
    diff = np.abs(gpu.astype(int) - cpu.astype(int)).max(-1)
    assert (diff > 1).mean() <= 0.005


def _area_layout_call(n_rays):
    """The R x S layout of an area light's shadow query: receivers on the
    floor, each with 100 rays toward the cells of a 10x10 square light, in
    receiver-major order as shadow_blocked flattens them, over three
    instances of the generated mesh (3 supergroups); padded to a multiple
    of 256 rays as the intersect module pads. Returns the K1 arguments."""
    from raytracer_tpu_torch.core import intersect as I

    rng = np.random.default_rng(5)
    p, _, _ = scenes.revolved_mesh()
    p = p * 0.03
    tris = np.concatenate([p + np.array([dx, 0.2, 0.0], np.float32)
                           for dx in (-1.2, 0.0, 1.2)])
    r = n_rays // 100
    over = np.stack([rng.uniform(-2, 2, r), np.full(r, 1e-3),
                     rng.uniform(-1, 1, r)], -1).astype(np.float32)
    k = np.arange(10, dtype=np.float32)
    cells = (np.array([-1.0, 3.0, -1.0], np.float32)
             + (k[:, None, None] + 0.5) * np.array([0.2, 0, 0], np.float32)
             + (k[None, :, None] + 0.5) * np.array([0, 0, 0.2], np.float32)
             ).reshape(100, 3)
    v = cells[None] - over[:, None]                             # [R,S,3]
    dist = np.linalg.norm(v, axis=-1)
    tri, bb = MC.pack_tri_planes_np(tris[:, 0], tris[:, 1] - tris[:, 0],
                                    tris[:, 2] - tris[:, 0])
    cu = lambda x: torch.as_tensor(np.ascontiguousarray(x), device="cuda")  # noqa: E731
    o, d, cap = I._pad_rays(
        cu(np.repeat(over, 100, axis=0)), cu((v / dist[..., None])
                                             .reshape(-1, 3)),
        cu(dist.reshape(-1).astype(np.float32)))
    assert o.shape[0] % MC.RT == 0 and tri.shape[0] == 3
    return (o, d, cu(tri), (cu(bb[0]), cu(bb[1]))), cap


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nearest", "any_hit"])
@pytest.mark.parametrize("rays", [65536, 1638400])
def test_kernel_matches_plain_in_area_light_layout(rays, mode):
    """K1 in the area-light layout (receivers x 100 samples, padded),
    launched whole: 65,536 rays (16 slices per subtile) and 1,638,400 rays
    (the main path's widest call: 1 slice, 6,400 CTAs). Its outputs against
    the plain version in 65,536-ray blocks: t to rtol 1e-5, index on >=
    99.9% of hits, existence and any-hit verdicts exact."""
    _require_cuda()
    block = 65536
    (o, d, planes, bb), cap = _area_layout_call(rays)
    assert o.shape[0] == rays
    assert MC.walk_slices(rays) == {65536: 16, 1638400: 1}[rays]
    kw = dict(any_hit=mode == "any_hit")
    before = MC.mesh_nearest.launches
    k = [x.cpu().numpy() for x in MC.mesh_nearest(o, d, planes, bb,
                                                  t_init=cap, **kw)]
    assert MC.mesh_nearest.launches == before + 1
    found = 0
    for b0 in range(0, rays, block):
        sl = slice(b0, b0 + block)
        p = [x.cpu().numpy() for x in MC.mesh_nearest_plain(
            o[sl], d[sl], planes, bb, t_init=cap[sl], **kw)]
        kt, ki = k[0][sl], k[1][sl]
        hit = np.isfinite(p[0])
        found += int(hit.sum())
        assert (np.isfinite(kt) == hit).all()
        np.testing.assert_allclose(kt[hit], p[0][hit], rtol=1e-5, atol=1e-8)
        if mode == "any_hit":
            assert (kt[hit] == 0.0).all()
        elif hit.any():
            assert (ki[hit] == p[1][hit]).mean() >= 0.999
    assert 0.01 < found / rays < 0.99


@pytest.mark.cuda
def test_csg_area_light_frame_cuda_matches_cpu():
    """CSG x a 10x10 area light (scenes.csg_area_yaml) at 96x54 in
    deterministic jitter mode: cuda against the CPU, at most 0.5% of
    pixels more than one u8 step apart."""
    _require_cuda()
    from raytracer_tpu_torch.scene.yaml_scene import parse_scene

    frames = []
    for dev in ("cuda", "cpu"):
        cam, sc = parse_scene(scenes.csg_area_yaml(96, 54), jitter=(0.5,),
                              device=dev)
        frames.append(render(sc, cam, quantize=True))
    diff = np.abs(frames[0].astype(int) - frames[1].astype(int)).max(-1)
    assert frames[0].std() > 1
    assert (diff > 1).mean() <= 0.005


@pytest.mark.cuda
def test_cli_subprocess_on_cuda(tmp_path):
    """``python -m raytracer_tpu_torch --device cuda`` on a small YAML
    scene: exit 0 and a PPM of the camera's size."""
    _require_cuda()
    import subprocess
    import sys
    from pathlib import Path

    from raytracer_tpu_torch.canvas import from_ppm_bytes

    root = Path(__file__).resolve().parents[1]
    scene = tmp_path / "scene.yaml"
    scene.write_text(
        "- add: camera\n  width: 32\n  height: 20\n  field-of-view: PI/3\n"
        "  from: [0, 1.5, -5]\n  to: [0, 1, 0]\n  up: [0, 1, 0]\n"
        "- add: point-light\n  at: [-10, 10, -10]\n  intensity: [1, 1, 1]\n"
        "- add: plane\n- add: sphere\n  transform:\n"
        "    - [translate, -0.5, 1, 0.5]\n")
    out = tmp_path / "out.ppm"
    proc = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "--scene", str(scene),
         "--out", str(out), "--device", "cuda"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    img = from_ppm_bytes(out.read_bytes())
    assert img.shape == (20, 32, 3) and img.max() > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["nearest", "reverse"])
def test_mesh_nearest_grad_cuda_matches_cpu(reverse):
    """MeshNearest on the card (the kernel forward, the torch recompute
    backward) against the CPU (the plain version forward) on the
    3-supergroup stream with caps: the gradients of sum(a.t + b.u + c.v)
    over hits with respect to origins, directions and the triangle rows,
    to rtol 1e-4 (atol 1e-5: the card scatters the triangle sums with
    atomics, in another order)."""
    _require_cuda()
    c = mesh_cases.stream_case(4096)
    tri, bb = MC.pack_tri_planes_np(c["p1"], c["e1"], c["e2"])
    w = np.random.default_rng(3).normal(0, 1, (3, 4096)).astype(np.float32)
    out = []
    for dev in ("cuda", "cpu"):
        def on(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        leaves = [on(c[k]).requires_grad_(True)
                  for k in ("o", "d", "p1", "e1", "e2")]
        before = MC.mesh_nearest.launches
        t, _, u, v = MC.MeshNearest.apply(
            *leaves, on(tri), (on(bb[0]), on(bb[1])),
            None if reverse else on(c["t_init"]), reverse)
        assert MC.mesh_nearest.launches == before + (dev == "cuda")
        hit = torch.isfinite(t)
        a, b, cc = (on(x) for x in w)
        torch.where(hit, a * torch.where(hit, t, 0.0) + b * u + cc * v,
                    0.0).sum().backward()
        out.append([hit.cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves])
    (hit_k, *g_k), (hit_p, *g_p) = out
    assert (hit_k == hit_p).all() and 100 < hit_p.sum() < 4000
    for name, x, y in zip(("o", "d", "p1", "e1", "e2"), g_k, g_p):
        assert np.isfinite(x).all(), name
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.cuda
def test_render_loss_and_grad_cuda_matches_cpu():
    """render_loss_and_grad (remat on) on the glass mesh_grad scene at
    32x24, depth 2: cuda against the CPU, the loss to rtol 1e-5 and every
    gradient table to rtol 1e-3, atol 1e-5; the backward pass recomputes
    the levels and launches the kernel again."""
    _require_cuda()
    from raytracer_tpu_torch.camera import ray_grid
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss, render_loss_and_grad)

    items, cam = scenes.mesh_grad(True, 32, 24)
    target = np.random.default_rng(0).uniform(0, 1, (32 * 24, 3)).astype(
        np.float32)
    res = []
    for dev in ("cuda", "cpu"):
        sc = build_scene(items, recursion_limit=2, device=dev)
        o, d = ray_grid(cam, device=dev)
        params, recombine = partition_scene(sc)
        res.append(render_loss_and_grad(params, recombine, o, d,
                                        torch.as_tensor(target, device=dev)))
        if dev == "cuda":
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss = render_loss(leaves, recombine, o, d,
                               torch.as_tensor(target, device=dev))
            before = MC.mesh_nearest.launches
            loss.backward()
            assert MC.mesh_nearest.launches > before
    (l_k, g_k), (l_p, g_p) = res
    np.testing.assert_allclose(float(l_k), float(l_p), rtol=1e-5)
    assert set(g_k) == set(g_p)
    for k in g_p:
        x = g_k[k].cpu().numpy()
        assert np.isfinite(x).all(), k
        np.testing.assert_allclose(x, g_p[k].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["glass_mesh4", "flagship", "csg_area"])
def test_graphed_frames_equal_eager(name):
    """render's tile program (each tile's levels replayed as CUDA graphs)
    against the eager loop (graphs=False): u8 frames bit-equal, the same
    K1 launches per frame (the graphed side counted from its replays), and
    a moved camera, and a frame of another width, reuse the program (its
    graphs read the camera and the width from buffers) and still equal the
    eager frame."""
    _require_cuda()
    from raytracer_tpu_torch import transforms as tf
    from raytracer_tpu_torch.camera import Camera
    from raytracer_tpu_torch.core import tile_program as TP
    from raytracer_tpu_torch.scene.yaml_scene import parse_scene

    if name == "csg_area":           # random area-light jitter, seed 0
        cam, sc = parse_scene(scenes.csg_area_yaml(64, 64), device="cuda")
    else:
        items, cam = (scenes.glass_mesh(instances=4, hsize=96, vsize=54)
                      if name == "glass_mesh4" else scenes.flagship(64, 48))
        sc = build_scene(items, device="cuda")
    frames = {}
    for graphs in (True, True, False):
        MC.reset_launches()
        frames.setdefault(graphs, []).append(
            (render(sc, cam, quantize=True, graphs=graphs),
             dict(MC.launch_counts())))
    (first, _), (graphed, k_graphed) = frames[True]
    eager, k_eager = frames[False][0]
    np.testing.assert_array_equal(first, eager)
    np.testing.assert_array_equal(graphed, eager)
    assert k_graphed == k_eager
    prog = TP.program_of(sc)
    assert prog.stats["captured"] == len(prog.graphs) > 0
    moved = Camera(cam.hsize, cam.vsize, cam.field_of_view).with_transform(
        tf.view_transform((0.5, 2.0, -6.0), (0.0, 0.8, 0.0), (0.0, 1.0, 0.0)))
    np.testing.assert_array_equal(
        render(sc, moved, quantize=True),
        render(sc, moved, quantize=True, graphs=False))
    # half the width, twice the height: the same pixels, so the same tile
    narrow = Camera(cam.hsize // 2, cam.vsize * 2, cam.field_of_view)
    narrow = narrow.with_transform(cam.transform)
    np.testing.assert_array_equal(
        render(sc, narrow, quantize=True),
        render(sc, narrow, quantize=True, graphs=False))
    assert TP.program_of(sc) is prog


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["keep", "remat"])
@pytest.mark.parametrize("name", ["glass_area", "flagship"])
def test_graphed_train_step_equals_eager(name, remat):
    """train_step through the train program (a microbatch one forward and
    one backward graph launch, its levels skipped or packed by conditional
    nodes) against graphs=False, two microbatches: the losses bit-equal,
    the updated tables within rtol 1e-3, atol 1e-5 (``index_add_`` adds in
    atomic order on the card), the same K1, K1b and table_gather forward
    launches per step (the graphed side counted from the level logs, after
    the first step, whose warm-up runs every branch once; table_gather's
    backward launches are not compared: a level's captured vjp runs the
    backward of every lookup of the level, eager autograd only of those
    its loss reaches); a second step, on a new scene object of new
    parameter tensors (the same values) and the same frozen tables, as a
    train step makes, captures nothing new."""
    _require_cuda()
    from raytracer_tpu_torch import transforms as tf
    from raytracer_tpu_torch.camera import Camera, ray_grid
    from raytracer_tpu_torch.core import train_program as TPG
    from raytracer_tpu_torch.parallel import partition_scene, train_step
    from raytracer_tpu_torch.scene import specs as S

    if name == "glass_area":   # K1 in three modes, packed levels, jitter
        items, _ = scenes.mesh_grad(True)
        cam = Camera(64, 128, scenes.GRAD_FOV).with_transform(
            tf.view_transform(scenes.GRAD_EYE, scenes.GRAD_TO,
                              scenes.GRAD_UP))
        items = [S.AreaLight(corner=(-3.0, 6.0, -4.0), uvec=(2.0, 0.0, 0.0),
                             usteps=2, vvec=(0.0, 0.0, 2.0), vsteps=2)
                 ] + items[1:]
        sc = build_scene(items, recursion_limit=2, device="cuda")
    else:
        items, cam = scenes.flagship(64, 48)
        sc = build_scene(items, device="cuda")
    o, d = ray_grid(cam, device="cuda")
    target = torch.full_like(o, 0.2)
    TPG.drop_programs()
    out = {}
    for graphs in (True, True, False):      # the first graphed step builds
        MC.reset_launches()
        g = torch.Generator(device="cuda").manual_seed(3)
        out[graphs] = (*train_step(sc, o, d, target, lr=0.05, n_micro=2,
                                   remat=remat, generator=g, graphs=graphs),
                       MC.launch_counts())
    (lg, sg, kg), (le, se, ke) = out[True], out[False]
    assert torch.equal(lg, le)
    from raytracer_tpu_torch.ops import gather_cuda as GA
    for key in GA.BACKWARD_KERNELS:
        kg.pop(key)
        ke.pop(key)
    assert kg == ke
    pg, pe = partition_scene(sg)[0], partition_scene(se)[0]
    for k in pe:
        torch.testing.assert_close(pg[k], pe[k], rtol=1e-3, atol=1e-5)
    (prog,) = TPG.programs()
    captured = prog.stats["captured"]
    assert captured == len(prog.graphs) > 0
    assert prog.stats["bodies"] > 0 and prog.stats["replays"] == 2 * 2 * 2
    if name == "glass_area":
        assert kg["k1"] > 0
        assert any(w is not None for _, _, w in prog.levels)
    params, recombine = partition_scene(sc)
    again = recombine({k: v.clone() for k, v in params.items()})
    g = torch.Generator(device="cuda").manual_seed(3)
    lg2, _ = train_step(again, o, d, target, lr=0.05, n_micro=2, remat=remat,
                        generator=g)
    assert torch.equal(lg2, lg)
    assert TPG.programs() == [prog] and prog.stats["captured"] == captured


def _paths_scene(device):
    """A mirror sphere low in the frame over a slightly reflective floor at
    64x32: the first half of the rays (the top rows) sees only sky, so its
    level 1 is dead; the second half's reflections run on."""
    import math

    from raytracer_tpu_torch import transforms as tf
    from raytracer_tpu_torch.camera import Camera, ray_grid
    from raytracer_tpu_torch.scene import specs as S

    items = [
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Plane(transform=tf.translation(0.0, -1.0, 0.0),
                material=S.Material(color=(0.9, 0.8, 0.7), specular=0.0,
                                    reflective=0.2)),
        S.Sphere(material=S.Material(color=(0.2, 0.3, 1.0), diffuse=0.6,
                                     reflective=0.6)),
    ]
    cam = Camera(64, 32, math.pi / 3).with_transform(
        tf.view_transform((0.0, 0.0, -5.0), (0.0, 1.3, 0.0),
                          (0.0, 1.0, 0.0)))
    o, d = ray_grid(cam, device=device)
    target = torch.as_tensor(np.random.default_rng(2).uniform(
        0, 1, (o.shape[0], 3)), dtype=torch.float32, device=device)
    return build_scene(items, recursion_limit=3, device=device), o, d, target


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["keep", "remat"])
def test_graphed_step_is_two_launches_per_microbatch(remat, monkeypatch):
    """A graphed gradient of two microbatches on different paths (the
    first dead from level 1): after the step that builds the program, a
    step is 2 x n_micro graph launches and one host sync (the level logs,
    at its end), with torch's sync debug mode set to raise, so no live
    count is read; the loss equal to graphs=False bit for bit, the
    gradients to rounding, and the paths read from the logs."""
    _require_cuda()
    from raytracer_tpu_torch.core import train_program as TPG
    from raytracer_tpu_torch.ops import graph_cuda as GC
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss_and_grad)

    sc, o, d, target = _paths_scene("cuda")
    params, recombine = partition_scene(sc)

    def step(graphs=True):
        return render_loss_and_grad(params, recombine, o, d, target,
                                    n_micro=2, remat=remat, graphs=graphs)

    step()                                       # builds the program
    calls = {"launch": 0, "sync": 0}
    real_launch = GC.TileGraph.launch

    def launch(self, device=None):
        calls["launch"] += 1
        return real_launch(self, device)

    monkeypatch.setattr(GC.TileGraph, "launch", launch)
    for owner in (torch.cuda, torch.cuda.Stream, torch.cuda.Event):
        real = owner.synchronize

        def sync(*a, _real=real, **kw):
            calls["sync"] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(owner, "synchronize", sync)
    torch.cuda.synchronize()
    calls.update(launch=0, sync=0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, grads = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert calls == {"launch": 2 * 2, "sync": 1}
    monkeypatch.undo()
    prog = TPG.programs()[0]
    micro = [[]]
    for level, _, _ in prog.levels:
        if level == 0 and micro[-1]:
            micro.append([])
        micro[-1].append(level)
    assert micro[0] == [0] and micro[1][:2] == [0, 1]
    want_loss, want = step(graphs=False)
    assert torch.equal(loss, want_loss)
    for k, g in want.items():
        torch.testing.assert_close(grads[k], g, rtol=1e-3, atol=1e-5)
    assert float(grads["mat"].abs().sum()) > 0


@pytest.mark.cuda
def test_backward_level_runs_the_flagged_body():
    """A toy level of the train program's shape on the card: a forward
    tile graph whose predicates part writes five flags (four packed widths
    and the dead level) from a live count, and a backward tile graph whose
    five IF bodies, each the captured vjp of a gather (``index_put_``'s
    accumulate, as a level's backward), read those kept flags: exactly the
    flagged body writes its gradient, launch after launch."""
    _require_cuda()
    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.core import types as T
    from raytracer_tpu_torch.ops import graph_cuda as GC

    GC.check_support()
    st = T.SceneStatic(counts=(0, 0, 0, 0, 0, 25280))
    rows = 4096
    branches = R.level_branches(st, rows, dead=True)
    n = len(branches)
    assert n == GC.MAX_BRANCHES
    live = torch.zeros((), dtype=torch.int64, device="cuda")
    flags = torch.zeros(n, dtype=torch.int32, device="cuda")
    x = torch.rand((64, 3), device="cuda", requires_grad=True)
    idx = torch.randint(0, 64, (rows,), device="cuda")
    out = torch.zeros((n, 64, 3), device="cuda")
    pool, side = torch.cuda.graph_pool_handle(), torch.cuda.Stream()

    def pred():
        flags.copy_(R.level_predicates(st, rows, live, dead=True))

    def body(k):
        with torch.enable_grad():
            y = x[idx] * float(k + 1)
            (g,) = torch.autograd.grad(y.sum(), x)
        out[k].copy_(g)

    def captured(fn):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                                   # warm-up
            g = torch.cuda.CUDAGraph(keep_graph=True)
            g.capture_begin(pool=pool)
            fn()
            g.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        return g

    # the parts outlive the tile graphs: their pool and memory are
    # what the graphs' kernels address
    pred_part = captured(pred)
    bodies = [captured(lambda k=k: body(k)) for k in range(n)]
    fwd = GC.TileGraph([pred_part])
    bwd = GC.TileGraph([(flags, bodies)])
    counts = torch.bincount(idx, minlength=64).float()[:, None].cpu()
    for n_live in (0, 1, rows // 16, rows // 16 + 1, rows // 2, rows, 0, 300):
        live.fill_(n_live)
        out.zero_()
        fwd.launch()
        bwd.launch()
        k = R.taken_branch(flags.cpu())
        assert branches[k] == (R.DEAD if n_live == 0
                               else R.level_width(st, rows, n_live))
        got = out.cpu()
        for j in range(n):
            want = counts * (j + 1) if j == k else torch.zeros(64, 1)
            assert torch.equal(got[j], want.expand(64, 3)), (n_live, j)


@pytest.mark.cuda
def test_tile_graph_runs_the_flagged_branch():
    """graph_cuda.TileGraph on a toy level: four branches, each a captured
    graph writing its mark; set_conditionals_kernel runs exactly the
    branch whose flag is set, or none, launch after launch, against its
    plain version (render.taken_branch of the same flags)."""
    _require_cuda()
    from raytracer_tpu_torch.core.render import taken_branch
    from raytracer_tpu_torch.ops import graph_cuda as GC

    GC.check_support()
    out = torch.zeros(4, dtype=torch.int32, device="cuda")
    flags = torch.zeros(4, dtype=torch.int32, device="cuda")
    pool, side = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
    bodies = []
    for k in range(4):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(side):
            g.capture_begin(pool=pool)
            out[k].fill_(k + 1)
            g.capture_end()
        bodies.append(g)
    tg = GC.TileGraph([(flags, bodies)])
    before = GC.set_conditionals_launches
    cases = [None, 0, 1, 2, 3, 2, None]
    for k in cases:
        flags.zero_()
        out.zero_()
        if k is not None:
            flags[k] = 1
        tg.launch()
        got = out.cpu()
        want = taken_branch(flags.cpu())
        assert want == k
        assert got.tolist() == [j + 1 if j == k else 0 for j in range(4)]
    assert GC.set_conditionals_launches == before + len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["glass_mesh4", "csg_area"])
def test_graphed_frame_is_one_launch_per_tile(name, monkeypatch):
    """A graphed frame on the card: one tile graph launch per tile and no
    synchronizing call inside ``frame`` (torch's sync debug mode set to
    raise, and the synchronize calls counted), u8 frames bit-equal to
    graphs=False, and the K1 and K1b launches counted from the level logs
    equal to the eager frame's."""
    _require_cuda()
    from raytracer_tpu_torch.core import render as R
    from raytracer_tpu_torch.core import tile_program as TP
    from raytracer_tpu_torch.ops import graph_cuda as GC
    from raytracer_tpu_torch.scene.yaml_scene import parse_scene

    if name == "csg_area":           # random area-light jitter, packed
        cam, sc = parse_scene(scenes.csg_area_yaml(64, 64), device="cuda")
    else:
        items, cam = scenes.glass_mesh(instances=4, hsize=96, vsize=54)
        sc = build_scene(items, device="cuda")
    render(sc, cam, quantize=True)               # captures
    prog = TP.program_of(sc)
    tile = prog.tile
    _, idx_tiles = R._order_tiles(cam.vsize, cam.hsize, tile, "cuda")
    inv, consts = R.camera_consts(cam, "cuda")
    calls = {"launch": 0, "sync": 0}
    real_launch = GC.TileGraph.launch

    def launch(self, device=None):
        calls["launch"] += 1
        return real_launch(self, device)

    monkeypatch.setattr(GC.TileGraph, "launch", launch)
    for owner in (torch.cuda, torch.cuda.Stream, torch.cuda.Event):
        real = owner.synchronize

        def sync(*a, _real=real, **kw):
            calls["sync"] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(owner, "synchronize", sync)
    torch.cuda.synchronize()
    calls.update(launch=0, sync=0)
    MC.reset_launches()
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            out = prog.frame(sc, inv, consts, cam.hsize, idx_tiles, True, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert calls == {"launch": len(idx_tiles), "sync": 0}
    prog.to_host(out)
    k_graphed = dict(MC.launch_counts())
    monkeypatch.undo()
    MC.reset_launches()
    graphed = render(sc, cam, quantize=True)
    k_render = dict(MC.launch_counts())
    MC.reset_launches()
    eager = render(sc, cam, quantize=True, graphs=False)
    k_eager = dict(MC.launch_counts())
    np.testing.assert_array_equal(graphed, eager)
    assert k_graphed == k_render == k_eager
    assert prog.frame_stats == dict(tiles=len(idx_tiles),
                                    replays=len(idx_tiles), syncs=1)
    if name == "glass_mesh4":
        assert k_eager["k1"] > 0
        assert any(w is not None for _, _, w in prog.levels)


GATHER_DTYPES = [torch.float32, torch.int32, torch.int64, torch.bool]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GATHER_DTYPES, ids=str)
@pytest.mark.parametrize("rest", [(), (3,), (27,), (5, 3)],
                         ids=["G", "Gx3", "Gx27", "Gx5x3"])
def test_table_gather_kernel_forward_equals_plain(rest, dtype):
    """table_gather's forward kernel against its plain version, bit for
    bit, for every dtype the call sites use, rows of 1 to 108 bytes (byte
    and 4-byte units), int32 and int64 indices of shapes [R] and [R, S]
    (at 131,072 x 4 B and more, the spans of 16-byte stores), out-of-range
    indices clamped, and a table that is a strided view."""
    _require_cuda()
    from raytracer_tpu_torch.ops import gather_cuda as GA

    gen = torch.Generator(device="cuda").manual_seed(1)
    for g in (1, 5, 300):
        full = torch.randint(-50, 50, (g, *rest), device="cuda",
                             generator=gen)
        table = full > 0 if dtype == torch.bool else (
            torch.randn((g, *rest), device="cuda", generator=gen)
            if dtype == torch.float32 else full.to(dtype))
        for shape in ((131_072,), (4096, 5)):
            for idx_dtype in (torch.int32, torch.int64):
                idx = torch.randint(-2, g + 2, shape, device="cuda",
                                    generator=gen).to(idx_dtype)
                before = GA.LAUNCHES["gather"]
                got = GA.gather_forward(table, idx)
                assert GA.LAUNCHES["gather"] == before + 1
                want = GA.gather_forward_plain(table, idx.long())
                assert got.dtype == dtype and got.shape == want.shape
                assert torch.equal(got, want)
        if rest == (3,):
            view = table.t().contiguous().t()         # strided rows
            assert torch.equal(GA.gather_forward(view, idx),
                               GA.gather_forward_plain(view, idx.long()))


@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes", [1, 3, 12, 27, 40, 108])
def test_table_gather_forward_row_sizes_unaligned(row_bytes):
    """The forward against its plain version bit for bit at rows of 1, 3,
    12, 27, 40 and 108 bytes (bool rows below 4-byte multiples, f32 rows
    above), at ray counts that are multiples of nothing, writing into
    outputs at offsets that break 16-byte (and for bool rows 4-byte)
    alignment."""
    _require_cuda()
    from raytracer_tpu_torch.ops import gather_cuda as GA

    gen = torch.Generator(device="cuda").manual_seed(row_bytes)
    f32 = row_bytes % 4 == 0
    cols = row_bytes // 4 if f32 else row_bytes
    for g in (1, 5, 57):
        table = (torch.randn((g, cols), device="cuda", generator=gen) if f32
                 else torch.rand((g, cols), device="cuda", generator=gen)
                 > 0.5)
        for n in (1, 33, 16_391, 131_075):
            idx = torch.randint(-1, g + 1, (n,), device="cuda",
                                generator=gen)
            want = GA.gather_forward_plain(table, idx)
            for shift in (0, 1, 2, 3):
                buf = torch.empty(n * cols + 4, dtype=table.dtype,
                                  device="cuda")
                out = buf[shift:shift + n * cols].view(n, cols)
                got = GA.gather_forward(table, idx, out=out)
                assert got.data_ptr() == out.data_ptr()
                assert torch.equal(got, want), (g, n, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("g,k", [(1, 10), (4, 10), (1025, 3),
                                 (2048 * 2048 + 1, 3)])
def test_table_gather_backward_odd_counts(g, k):
    """The backward (_check_backward: twice bit-equal, within rtol 1e-5 of
    the f64 sum) at 524,287 rays, a prime, on both routes."""
    _require_cuda()
    from raytracer_tpu_torch.ops import gather_cuda as GA

    gen = torch.Generator(device="cuda").manual_seed(g)
    n = 524_287
    idx = torch.where(torch.rand(n, device="cuda", generator=gen) < 0.9,
                      torch.randint(0, min(g, 5), (n,), device="cuda",
                                    generator=gen),
                      torch.randint(0, g, (n,), device="cuda",
                                    generator=gen))
    _check_backward(GA, torch.randn((n, k), device="cuda", generator=gen),
                    idx, g)


@pytest.mark.cuda
@pytest.mark.parametrize("g,k", [(4, 10), (300, 3), (5000, 3)],
                         ids=["one_tile", "tiles", "fixed"])
def test_table_gather_backward_replays_equal_eager(g, k):
    """The backward captured alone in a CUDA graph and replayed three times
    on the same inputs: every replay bit-equal to the eager call, made
    before the capture and again after the replays (the tile route's last
    CTA leaves its arrival counter at zero for the next launch)."""
    _require_cuda()
    from raytracer_tpu_torch.ops import gather_cuda as GA

    gen = torch.Generator(device="cuda").manual_seed(k)
    n = 524_288
    idx = torch.randint(0, g, (n,), device="cuda", generator=gen)
    grad = torch.randn((n, k), device="cuda", generator=gen)
    eager = GA.gather_backward(grad, idx, g)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = GA.gather_backward(grad, idx, g)
    for _ in range(3):
        static.zero_()
        graph.replay()
        assert torch.equal(static.view(torch.int32), eager.view(torch.int32))
    again = GA.gather_backward(grad, idx, g)
    assert torch.equal(again.view(torch.int32), eager.view(torch.int32))


def _backward_kernels(GA, n, g, k):
    """The backward kernels one call launches for n indices into a [g, k]
    table, by the route its size picks."""
    if GA._library().table_gather_fixed(n, g, k):
        return {"gather_scale": 1, "gather_add": 1, "gather_finish": 1}
    return {"gather_grad": 1}


def _check_backward(GA, grad, idx, g):
    """table_gather's backward kernel on (grad, idx) against the f64 sum
    by index, to rtol 1e-5 of the sum of the terms' magnitudes, as the
    plain version (``index_add_``) is; two calls (int64 and int32
    indices) equal bit for bit; each launch counted on its kernel; rows
    no index reaches exactly 0."""
    rest = grad.shape[idx.dim():]
    want = torch.zeros((g, *rest), dtype=torch.float64, device="cuda")
    want.index_add_(0, idx, grad.double())
    scale = torch.zeros_like(want).index_add_(0, idx, grad.double().abs())
    before = GA.launch_counts()
    got = GA.gather_backward(grad, idx, g)
    again = GA.gather_backward(grad, idx.int(), g)
    launched = {k: v - before[k] for k, v in GA.launch_counts().items()
                if v != before[k]}
    per_call = _backward_kernels(GA, idx.numel(), g, grad[0].numel())
    assert launched == {k: 2 * v for k, v in per_call.items() if v}
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, again)
    plain = GA.gather_backward_plain(grad, idx, g)
    for x in (got, plain):
        assert bool(((x.double() - want).abs() <= 1e-5 * scale).all())
    unread = torch.ones(g, dtype=torch.bool, device="cuda")
    unread[idx] = False
    assert bool((got[unread] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rest", [(), (3,), (10,), (27,), (5, 3), (700,)],
                         ids=["G", "Gx3", "Gx10", "Gx27", "Gx5x3", "Gx700"])
@pytest.mark.parametrize("g", [1, 5, 33, 300, 1025])
def test_table_gather_kernel_backward(g, rest):
    """table_gather's backward kernel (_check_backward) on train-shaped
    inputs: most rays on a few rows. The cases cross both routes: the
    tile route up to TILES_MAX tiles of the table, the fixed-point route
    beyond (G 1025 at every K, G 300 at K 700)."""
    _require_cuda()
    from raytracer_tpu_torch.ops import gather_cuda as GA

    gen = torch.Generator(device="cuda").manual_seed(g)
    n = 131_072 if rest != (700,) else 8192
    hot = torch.randint(0, min(g, 5), (n,), device="cuda", generator=gen)
    spread = torch.randint(0, g, (n,), device="cuda", generator=gen)
    idx = torch.where(torch.rand(n, device="cuda", generator=gen) < 0.9,
                      hot, spread)
    grad = torch.randn((n, *rest), device="cuda", generator=gen)
    _check_backward(GA, grad, idx, g)


@pytest.mark.cuda
def test_table_gather_kernel_backward_large_table():
    """The backward on an image's texels: a [G, 3] table of a 2048 x 2048
    image and one row more (4,194,305 rows; grid.y's 65,535 tiles of 64
    rows at K 3 would hold 4,194,240), 131,072 rays on texels spread over
    the image, a tenth of them on five hot texels (_check_backward)."""
    _require_cuda()
    from raytracer_tpu_torch.ops import gather_cuda as GA

    gen = torch.Generator(device="cuda").manual_seed(17)
    n, g = 131_072, 2048 * 2048 + 1
    hot = torch.randint(0, 5, (n,), device="cuda", generator=gen)
    spread = torch.randint(0, g, (n,), device="cuda", generator=gen)
    idx = torch.where(torch.rand(n, device="cuda", generator=gen) < 0.1,
                      hot, spread)
    grad = torch.randn((n, 3), device="cuda", generator=gen)
    assert GA._library().table_gather_fixed(n, g, 3) == 1
    _check_backward(GA, grad, idx, g)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [5, 5000], ids=["tile", "fixed"])
def test_table_gather_kernel_backward_non_finite(g):
    """Infinite and NaN terms on both routes, as a float sum takes them:
    a row column with +inf terms only is +inf, with -inf only -inf, with
    both NaN, with a NaN NaN; every other column the sum of its terms."""
    _require_cuda()
    from raytracer_tpu_torch.ops import gather_cuda as GA

    gen = torch.Generator(device="cuda").manual_seed(23)
    n, inf = 65_536, float("inf")
    idx = torch.randint(0, g, (n,), device="cuda", generator=gen)
    idx[:8] = torch.tensor([0, 0, 1, 1, 1, 2, 2, 3], device="cuda")
    grad = torch.randn((n, 3), device="cuda", generator=gen)
    grad[:8, 0] = torch.tensor([inf, inf, -inf, 1.0, -inf, inf, -inf,
                                float("nan")], device="cuda")
    got = GA.gather_backward(grad, idx, g)
    again = GA.gather_backward(grad, idx, g)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    col = got[:4, 0].tolist()
    assert col[0] == inf and col[1] == -inf
    assert col[2] != col[2] and col[3] != col[3]       # NaN
    want = GA.gather_backward_plain(grad.double(), idx, g)
    finite = torch.ones_like(got, dtype=torch.bool)
    finite[:4, 0] = False
    torch.testing.assert_close(got[finite], want[finite].float(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_table_gather_capture_and_replay_equal_eager():
    """table_gather forward and backward (through autograd) captured in
    one torch.cuda.CUDAGraph and replayed on new indices and gradients
    copied into its static inputs: output and table gradient equal to the
    eager calls bit for bit."""
    _require_cuda()
    from raytracer_tpu_torch.core.intersect import table_gather

    gen = torch.Generator(device="cuda").manual_seed(5)
    table = torch.randn((5, 27), device="cuda", generator=gen,
                        requires_grad=True)
    idx = torch.randint(0, 5, (65_536,), device="cuda", generator=gen)
    w = torch.randn((65_536, 27), device="cuda", generator=gen)

    def step():
        out = table_gather(table, idx)
        (g,) = torch.autograd.grad((out * w).sum(), table)
        return out, g

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                                         # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out, static_g = step()
    for seed in (6, 7):
        gen.manual_seed(seed)
        idx.copy_(torch.randint(0, 5, idx.shape, device="cuda",
                                generator=gen))
        w.copy_(torch.randn(w.shape, device="cuda", generator=gen))
        graph.replay()
        out, g = step()
        assert torch.equal(static_out, out)
        assert torch.equal(static_g, g)


@pytest.mark.cuda
def test_flagship_train_graphed_step_bit_equal_eager():
    """A flagship_train step (train_step's gradient, n_micro=4, remat off)
    through the train program against graphs=False on the card: the loss
    and every gradient table equal bit for bit, table_gather's forward
    and backward kernels launched, the forward as often on both sides (the
    graphed side counted from the level logs, after the step that builds
    it; its captured vjps run the backward of every lookup of a level,
    eager autograd only of those the loss reaches), and no event of
    PyTorch's indexing backward in a graphed step's profile."""
    _require_cuda()
    from raytracer_tpu_torch.camera import ray_grid
    from raytracer_tpu_torch.core import train_program as TPG
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss_and_grad)

    items, cam = scenes.flagship(64, 48)
    sc = build_scene(items, device="cuda")
    o, d = ray_grid(cam, device="cuda")
    target = torch.zeros_like(o)
    params, recombine = partition_scene(sc)
    TPG.drop_programs()
    out = {}
    for graphs in (True, True, False):          # the first graphed builds
        MC.reset_launches()
        out[graphs] = (*render_loss_and_grad(
            params, recombine, o, d, target, n_micro=4, remat=False,
            graphs=graphs), MC.launch_counts())
    (lg, gg, kg), (le, ge, ke) = out[True], out[False]
    assert torch.equal(lg, le)
    for k in ge:
        assert torch.equal(gg[k], ge[k]), k
    assert kg["gather"] == ke["gather"] > 0
    assert kg["gather_grad"] >= ke["gather_grad"] > 0
    assert float(ge["mat"].abs().sum()) > 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        render_loss_and_grad(params, recombine, o, d, target, n_micro=4,
                             remat=False)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not any("indexing_backward" in k for k in names)
    assert any("table_gather_grad_kernel" in k for k in names)


@pytest.mark.cuda
def test_textured_train_step_2048_image():
    """A train gradient of a scene whose floor carries a 2048 x 2048
    image texture (4,194,304 texels, a trained table): graphed and
    eager equal bit for bit, the texels' gradient through
    table_gather's fixed-point route (no G is too large for the grid),
    finite and on many texels, its sum and the loss within rtol 1e-3 of
    the CPU's."""
    _require_cuda()
    from raytracer_tpu_torch.camera import ray_grid
    from raytracer_tpu_torch.core import train_program as TPG
    from raytracer_tpu_torch.ops import gather_cuda as GA
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss_and_grad)
    from raytracer_tpu_torch.scene import specs as S

    image = np.random.default_rng(29).random((2048, 2048, 3), np.float32)
    items, cam = scenes.flagship(64, 48)
    items[1] = S.Plane(material=S.Material(specular=0.0, pattern=S.Pattern(
        "texture_map", mapping="planar", transform=np.diag(
            [4.0, 4.0, 4.0, 1.0]).astype(np.float32),
        uv_pattern=S.UvPatternSpec("image", image=image))))
    TPG.drop_programs()
    out = {}
    for dev, graphs in (("cuda", True), ("cuda", True), ("cuda", False),
                        ("cpu", False)):
        sc = build_scene(items, device=dev)
        assert sc.images.shape == (1, 2048, 2048, 3)
        o, d = ray_grid(cam, device=dev)
        params, recombine = partition_scene(sc)
        MC.reset_launches()
        out[(dev, graphs)] = (*render_loss_and_grad(
            params, recombine, o, d, torch.zeros_like(o), n_micro=2,
            remat=False, graphs=graphs), GA.launch_counts())
    (lg, gg, kg), (le, ge, ke) = out[("cuda", True)], out[("cuda", False)]
    lc, gc, _ = out[("cpu", False)]
    assert torch.equal(lg, le)
    for k in ge:
        assert torch.equal(gg[k], ge[k]), k
    assert ke["gather_scale"] == ke["gather_add"] == ke["gather_finish"] > 0
    img = ge["images"]
    assert bool(torch.isfinite(img).all())
    assert int((img != 0).any(-1).sum()) > 100
    torch.testing.assert_close(le.cpu(), lc, rtol=1e-3, atol=0)
    torch.testing.assert_close(img.sum().cpu(), gc["images"].sum(),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.cuda
def test_graphed_microbatched_loss_is_sum_times_reciprocal():
    """At n_micro=3 a graphed step's loss is the microbatch losses' sum
    times fl(1/3), bit for bit, as the JAX package rounds it (ROADMAP
    F7). On the card PyTorch divides a tensor by a scalar as a product
    with its reciprocal, so x / 3 rounds the same there; the CPU test
    (test_torch_train_control.py) holds a case where they differ."""
    _require_cuda()
    from raytracer_tpu_torch.camera import ray_grid
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss, render_loss_and_grad)

    items, cam = scenes.flagship(48, 16)
    sc = build_scene(items, device="cuda")
    o, d = ray_grid(cam, device="cuda")
    params, recombine = partition_scene(sc)
    m = o.shape[0] // 3
    for seed in range(4):
        target = torch.as_tensor(np.random.default_rng(seed).uniform(
            0, 1, (o.shape[0], 3)), dtype=torch.float32, device="cuda")
        loss, _ = render_loss_and_grad(params, recombine, o, d, target,
                                       n_micro=3, remat=False)
        total = torch.zeros((), device="cuda")
        with torch.no_grad():
            for i in range(3):
                sl = slice(i * m, (i + 1) * m)
                total = total + render_loss(params, recombine, o[sl], d[sl],
                                            target[sl], remat=False)
        assert torch.equal(loss, total * (1.0 / 3))
