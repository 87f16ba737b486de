"""CSG intersection filtering, data-parallel.

Counterpart of ``raytracer_tpu/core/csg.py``. The reference filters a
sorted intersection list through a sequential state machine per CSG node
(csg.rs:51-72), walking hits in t-order while toggling in_l/in_r and
keeping the hits the op's truth table allows (csg.rs:117-123); nested
trees recurse, a child node filtering its own hits first (csg.rs:26-49).

Here in_l/in_r *before* hit j are parities of how many earlier (alive,
in-subtree) hits were left/right hits. Processing nodes bottom-up with an
"alive" mask reproduces the recursion exactly. The uint64 membership masks
stay host-side numpy; the column indices and per-node bit masks they give
are tensors made once per scene (:func:`_root_plans`). Ties in t break by
column index in both filters. On the card a root of up to 32 columns goes
to one hand-written kernel where no gradient flows
(``ops/csg_cuda.py``), bit for bit the pairwise filter's result.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.core import types as T
from raytracer_tpu_torch.ops import csg_cuda as CC
from raytracer_tpu_torch.utils import profiling as P


def _op_allowed(op_code, l_hit, in_l, in_r):
    """csg.rs:117-123 truth table (elementwise)."""
    union = (l_hit & ~in_r) | (~l_hit & ~in_l)
    inter = (l_hit & in_r) | (~l_hit & in_l)
    diff = (l_hit & ~in_r) | (~l_hit & in_l)
    return {T.CSG_UNION: union, T.CSG_INTERSECT: inter,
            T.CSG_DIFFERENCE: diff}[op_code]


# Columns above which the sorted path replaces the O(C^2) pairwise parity
# (CSG over meshes: hundreds of triangle columns), as in the JAX package.
PAIRWISE_MAX_COLS = 128


def apply_csg(scene: T.Scene, ts, static_gids: np.ndarray, c_static: int):
    """Set t=+inf for candidate intersections the CSG rules disallow.

    ``ts`` is [R, C]; only the first ``c_static`` columns (gids
    ``static_gids``) can belong to CSG trees. Returns the filtered ts (a
    new tensor; the input is not written). A root goes to the kernel
    (``csg_cuda.csg_filter``) where ``csg_cuda.takes_kernel`` holds, else
    to a plain filter (counted in ``csg_cuda.LAUNCHES["csg_plain"]``).
    The body is the stage mark ``csg_filter`` (``utils/profiling.mark``),
    on the shading path and on the shadow path alike.
    """
    if not scene.static.csg_nodes:
        return ts
    with P.mark("csg_filter"):
        for idx, pairwise, plan, packed in _root_plans(scene, static_gids):
            if CC.takes_kernel(ts, packed):
                ts = CC.csg_filter(ts, packed)
            else:
                sub = ts[:, idx]                            # [R, Cr]
                new_sub = (_filter_pairwise if pairwise
                           else _filter_sorted)(sub, plan)
                ts = ts.index_copy(1, idx, new_sub)
                CC.LAUNCHES["csg_plain"] += 1
    return ts


def _root_plans(scene: T.Scene, static_gids: np.ndarray):
    """Per CSG root with a column among ``static_gids``: (its columns as a
    tensor, whether the pairwise filter takes them, its node plan, the
    kernel's packed plan or None: ``csg_cuda.pack_plan``), made once per
    scene and column layout."""
    def build():
        st = scene.static
        member = {gid: (under, left) for gid, under, left in st.csg_members}
        plans = []
        for root in sorted({root for _, _, root in st.csg_nodes}):
            root_mask = 1 << root
            cols = [
                j for j in range(len(static_gids))
                if member.get(int(static_gids[j]), (0, 0))[0] & root_mask
            ]
            if not cols:
                continue
            under_bits = np.array(
                [member[int(static_gids[j])][0] for j in cols], np.uint64)
            left_bits = np.array(
                [member[int(static_gids[j])][1] for j in cols], np.uint64)
            nodes = [n for n in st.csg_nodes if n[2] == root]
            plans.append((torch.as_tensor(cols, device=scene.device),
                          len(cols) <= PAIRWISE_MAX_COLS,
                          _node_plan(nodes, under_bits, left_bits,
                                     scene.device),
                          CC.pack_plan(cols, nodes, under_bits, left_bits,
                                       len(static_gids), scene.device)))
        return plans

    return scene.const(("csg", static_gids.tobytes()), build)


def _node_bits(bits: np.ndarray, bit: int, device):
    """Bit ``bit`` of each column's uint64 mask, as a bool tensor."""
    return torch.as_tensor(((bits >> np.uint64(bit)) & np.uint64(1))
                           .astype(bool), device=device)


def _node_plan(nodes, under_bits, left_bits, device):
    """(op code, under-node mask [Cr], left-child mask [Cr]) per node, in
    the bottom-up order of ``nodes``: what the filters read."""
    return [(op_code, _node_bits(under_bits, bit, device),
             _node_bits(left_bits, bit, device))
            for op_code, bit, _ in nodes]


def _filter_pairwise(sub, plan):
    """Sortless node loop: the count of earlier hits from pairwise
    lexicographic (t, column) comparisons, two [R, Cr, Cr] reductions per
    node (ties break by column index, as the stable sort does). ``plan``:
    :func:`_node_plan`."""
    c = sub.shape[-1]
    dev = sub.device
    alive = torch.isfinite(sub)
    # earlier[r, i, j]: hit i strictly precedes hit j in the sorted order
    tie = torch.ones((c, c), dtype=torch.bool, device=dev).triu(1)  # i < j
    earlier = (sub[:, :, None] < sub[:, None, :]) | (
        (sub[:, :, None] == sub[:, None, :]) & tie[None])

    for op_code, under_n, l_hit in plan:
        under_n, l_hit = under_n[None], l_hit[None]
        relevant = under_n & alive                          # [R, Cr]
        inc_l = relevant & l_hit
        inc_r = relevant & ~l_hit
        cnt_l = (inc_l[:, :, None] & earlier).sum(1)
        cnt_r = (inc_r[:, :, None] & earlier).sum(1)
        allowed = _op_allowed(op_code, l_hit, cnt_l % 2 == 1, cnt_r % 2 == 1)
        alive = torch.where(relevant, allowed, alive)

    return torch.where(alive, sub, float("inf"))


def _filter_sorted(sub, plan):
    """Stable argsort + exclusive prefix parity (the wide-tree path)."""
    order = torch.argsort(sub, dim=-1, stable=True)
    sub_sorted = torch.gather(sub, -1, order)
    alive = torch.isfinite(sub_sorted)

    for op_code, under_n, l_hit in plan:
        under_n, l_hit = under_n[order], l_hit[order]
        relevant = under_n & alive
        inc_l = (relevant & l_hit).to(torch.int32)
        inc_r = (relevant & ~l_hit).to(torch.int32)
        # exclusive prefix: the state BEFORE hit j
        in_l = (torch.cumsum(inc_l, -1) - inc_l) % 2 == 1
        in_r = (torch.cumsum(inc_r, -1) - inc_r) % 2 == 1
        allowed = _op_allowed(op_code, l_hit, in_l, in_r)
        alive = torch.where(relevant, allowed, alive)

    filtered = torch.where(alive, sub_sorted, float("inf"))
    # scatter back through the inverse permutation
    inv_order = torch.argsort(order, dim=-1)
    return torch.gather(filtered, -1, inv_order)
