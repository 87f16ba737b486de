"""Multi-process rendering and training of raytracer_tpu_torch
(``parallel/mesh.py``, ``make_sharded_train_step``) over gloo on the CPU.

Two worker processes (this file run as a script; they import torch and
the port only) render one frame with ``render_sharded`` through the default
group, a 1-D mesh and a 2-D host mesh, take one sharded train step (and
one over the host mesh) and shard a 5-ray batch; the tests hold what they
wrote against the single-process port and the JAX package. Bounds: frames to 1e-5 on at
least 99.9% of pixels (all, so far), losses to rtol 1e-5, updated tables
to rtol 1e-4.
"""

import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FRAME = (64, 32)
BATCH = (32, 16)     # the train step's rays: 512, 256 a rank
LR = 0.05


def frame_items():
    """Point light, reflective plane, a sphere and a 96-triangle mesh."""
    from raytracer_tpu_torch import transforms as tf
    from raytracer_tpu_torch.scene import specs as S

    rng = np.random.default_rng(4)
    p = (rng.uniform(-0.4, 0.4, (96, 1, 3))
         + rng.normal(0.0, 0.15, (96, 3, 3)) + np.array([1.2, 0.6, -0.5]))
    return [
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Plane(material=S.Material(specular=0.0, reflective=0.3)),
        S.Sphere(transform=tf.translation(-0.5, 1.0, 0.5),
                 material=S.Material(color=(0.1, 0.4, 0.9), diffuse=0.7)),
        S.Mesh(p=p.astype(np.float32),
               material=S.Material(color=(0.9, 0.4, 0.1))),
    ]


def camera(hsize, vsize):
    from raytracer_tpu_torch import transforms as tf
    from raytracer_tpu_torch.camera import Camera

    return Camera(hsize, vsize, math.pi / 3).with_transform(
        tf.view_transform((0, 1.5, -5), (0, 1, 0), (0, 1, 0)))


def train_batch():
    """(scene, origins, directions, target) of the train step."""
    from raytracer_tpu_torch.camera import ray_grid
    from raytracer_tpu_torch.scene import build_scene

    scene = build_scene(frame_items(), recursion_limit=2, device="cpu")
    o, d = ray_grid(camera(*BATCH), device="cpu")
    return scene, o, d, torch.full_like(o, 0.3)


def worker(rank, world, port, out):
    """One rank: frames, one train step and a shard of a 5-ray batch, all
    written to ``out``."""
    sys.path.insert(0, str(REPO))
    from raytracer_tpu_torch.parallel import (
        init_distributed, make_host_mesh, make_mesh, make_sharded_train_step,
        partition_scene, render_sharded, shard_rays)
    from raytracer_tpu_torch.scene import build_scene

    got = init_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                           device="cpu")
    assert got == (rank, world), got
    res = {}
    scene = build_scene(frame_items(), device="cpu")
    cam = camera(*FRAME)
    res["frame_world"] = render_sharded(scene, cam)
    res["frame_mesh"] = render_sharded(scene, cam, make_mesh("cpu"))
    res["frame_hosts"] = render_sharded(scene, cam, make_host_mesh("cpu"))

    scene, o, d, target = train_batch()
    o_l, d_l, n = shard_rays(o, d)
    t_l = target[rank * (n // world):(rank + 1) * (n // world)]
    step = make_sharded_train_step(lr=LR, n_micro=2, remat=False)
    loss, new = step(scene, o_l, d_l, t_l)
    res["loss"] = float(loss)
    # over the 2-D mesh: the reduction runs per dimension
    host_step = make_sharded_train_step(make_host_mesh("cpu"), lr=LR,
                                        n_micro=2, remat=False)
    res["loss_hosts"] = float(host_step(scene, o_l, d_l, t_l)[0])
    for k, v in partition_scene(new)[0].items():
        res[f"param_{k}"] = v.numpy()

    o5, d5, n5 = shard_rays(o[:5], d[:5])
    res["shard5"] = np.concatenate([o5.numpy(), d5.numpy()], 1)
    res["shard5_n"] = n5
    np.savez(out, **res)
    torch.distributed.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (two gloo processes)."""
    tmp = tmp_path_factory.mktemp("dist")
    port = free_port()
    # one rank per "host": make_host_mesh gives a (2, 1) mesh
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO),
               LOCAL_WORLD_SIZE="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "2", str(port),
         str(tmp / f"rank{r}.npz")],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, (out[-2000:], err[-4000:])
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def assert_frames_close(got, want):
    """|got - want| <= 1e-5 on at least 99.9% of pixels."""
    off = (np.abs(got - want) > 1e-5).any(-1)
    assert off.mean() <= 0.001, int(off.sum())


def test_sharded_frame_equals_render(ranks):
    from raytracer_tpu_torch.core.render import render
    from raytracer_tpu_torch.scene import build_scene

    want = render(build_scene(frame_items(), device="cpu"), camera(*FRAME))
    for key in ("frame_world", "frame_mesh", "frame_hosts"):
        a, b = ranks[0][key], ranks[1][key]
        assert a.shape == (FRAME[1], FRAME[0], 3)
        assert np.array_equal(a, b), key
        assert_frames_close(a, want)
    assert want.std() > 0.05


def test_sharded_frame_matches_jax_render_sharded(ranks):
    """The JAX package's render_sharded on a 1-device CPU mesh, the same
    tables."""
    import jax

    from raytracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from raytracer_tpu.parallel.mesh import render_sharded as jax_sharded
    from torch_port_helpers import jax_camera, same_tables

    js, _ = same_tables(frame_items())
    want = jax_sharded(js, jax_camera(camera(*FRAME)),
                       jax_make_mesh(jax.devices()[:1]))
    assert_frames_close(ranks[0]["frame_world"], want)


def test_sharded_train_step_equals_single_process(ranks):
    """Loss and updated tables of one two-rank step (n_micro=2 per rank)
    against render_loss_and_grad over the whole batch and its SGD update,
    in this process."""
    from raytracer_tpu_torch.parallel import (
        partition_scene, render_loss_and_grad)

    scene, o, d, target = train_batch()
    params, recombine = partition_scene(scene)
    loss, grads = render_loss_and_grad(params, recombine, o, d, target,
                                       remat=False)
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert ranks[0]["loss_hosts"] == ranks[1]["loss_hosts"]
    np.testing.assert_allclose(ranks[0]["loss_hosts"], ranks[0]["loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["loss"], float(loss), rtol=1e-5)
    moved = 0
    for k, p in params.items():
        want = (p - LR * grads[k]).numpy()
        a, b = ranks[0][f"param_{k}"], ranks[1][f"param_{k}"]
        assert np.array_equal(a, b), k
        np.testing.assert_allclose(a, want, rtol=1e-4, atol=1e-7,
                                   err_msg=k)
        moved += int((a != p.numpy()).sum())
    assert moved > 0


def test_shard_rays_pads_and_splits(ranks):
    """5 rays over 2 ranks: one padding ray (origin 0, direction +z), 3
    rays a rank, n = 5; one process alone keeps the batch."""
    from raytracer_tpu_torch.parallel import shard_rays

    _, o, d, _ = train_batch()
    for r in range(2):
        assert int(ranks[r]["shard5_n"]) == 5
    both = np.concatenate([ranks[0]["shard5"], ranks[1]["shard5"]])
    assert both.shape == (6, 6)
    np.testing.assert_array_equal(both[:5, :3], o[:5].numpy())
    np.testing.assert_array_equal(both[:5, 3:], d[:5].numpy())
    np.testing.assert_array_equal(both[5], [0, 0, 0, 0, 0, 1])
    o1, d1, n1 = shard_rays(o[:5], d[:5])
    assert n1 == 5 and torch.equal(o1, o[:5]) and torch.equal(d1, d[:5])


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
