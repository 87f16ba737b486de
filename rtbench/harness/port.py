"""The harness's side of the program: the few helpers that the loops
share. Only the program's public entry points are called."""

from __future__ import annotations

import numpy as np


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def block_order(vsize, hsize, block=16):
    """Flat pixel ids (py * hsize + px) in render's block order: blocks of
    ``block`` x ``block`` pixels in row-major order, each block's pixels
    in row-major order."""
    py, px = np.divmod(np.arange(vsize * hsize), hsize)
    keys = (px % block, py % block, px // block, py // block)
    return np.lexsort(keys)


def launch_counts():
    """The program's launch counters of K1, K1b and table_gather
    (ops/mesh_cuda.launch_counts)."""
    from raytracer_tpu_torch.ops import mesh_cuda

    return mesh_cuda.launch_counts()


def train_capture_s():
    """Seconds the train programs kept spent warming up and capturing."""
    from raytracer_tpu_torch.core import train_program

    return sum(p.stats["capture_s"] for p in train_program.programs())


def drop_train_programs():
    from raytracer_tpu_torch.core import train_program

    train_program.drop_programs()


def peak_bytes(device):
    """The process's peak of device memory reserved (what the card must
    hold), 0 off the card."""
    import torch

    return int(torch.cuda.max_memory_reserved(device)) \
        if device.type == "cuda" else 0


def free(device):
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
