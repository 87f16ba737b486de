"""CSG filter cases shared by the CPU tests and the card tests (no JAX):
random trees in the scene builder's encoding, tables of hits with the
values that order awkwardly, and the kernel's bitwise algorithm written
out in numpy.

A tree here is what ``csg._root_plans`` reads of a scene: the root's
columns in the table, its nodes ``(op, bit, root bit)`` bottom-up, and
each column's uint64 under and left masks (scene/builder.py: a node's bit
is set in the under mask of every column in its subtree, and in the left
mask of every column in its left child).
"""

import numpy as np

from raytracer_tpu_torch.core import types as T

OPS = (T.CSG_UNION, T.CSG_INTERSECT, T.CSG_DIFFERENCE)


def random_tree(rng, n_nodes, width, n_cols):
    """A random root of ``n_nodes`` op nodes over ``width`` columns of an
    ``n_cols``-column table (the others lie outside the tree): (cols,
    nodes, under_bits, left_bits). Every leaf holds at least one column;
    the node bits start at a random offset, up to bit 63."""
    assert n_nodes + 1 <= width <= n_cols
    cols = sorted(rng.choice(n_cols, width, replace=False).tolist())
    leaf_of = np.concatenate([np.arange(n_nodes + 1),
                              rng.integers(0, n_nodes + 1,
                                           width - n_nodes - 1)])
    rng.shuffle(leaf_of)
    under = np.zeros(width, np.uint64)
    left = np.zeros(width, np.uint64)
    nodes = []
    next_bit = [int(rng.integers(0, 64 - n_nodes))]
    root_bit = next_bit[0]
    leaves = iter(range(n_nodes + 1))

    def build(k, u, lf):
        """A subtree of k op nodes; u, lf: the masks its columns inherit."""
        if k == 0:
            mine = leaf_of == next(leaves)
            under[mine] = np.uint64(u)
            left[mine] = np.uint64(lf)
            return
        bit = next_bit[0]
        next_bit[0] += 1
        k_left = int(rng.integers(0, k))
        build(k_left, u | 1 << bit, lf | 1 << bit)
        build(k - 1 - k_left, u | 1 << bit, lf)
        nodes.append((int(rng.choice(OPS)), bit, root_bit))

    build(n_nodes, 0, 0)
    return cols, nodes, under, left


def random_ts(rng, r, c):
    """[r, c] f32 hits: normal t of both signs, a quarter +inf, a few
    -inf and NaN, exact ties (a column copied into another, and rows
    rounded to whole numbers), and signed zeros."""
    ts = rng.normal(0, 3, (r, c)).astype(np.float32)
    ts[rng.uniform(size=ts.shape) < 0.25] = np.inf
    ts[rng.uniform(size=ts.shape) < 0.02] = -np.inf
    ts[rng.uniform(size=ts.shape) < 0.02] = np.nan
    if c > 1:
        ts[::3, -1] = ts[::3, 0]
    ts[1::4] = np.round(ts[1::4])
    ts[2::16, : (c + 1) // 2] = 0.0
    ts[2::16, (c + 1) // 2:] = -0.0
    return ts


def filter_bits(ts, plan):
    """csrc/csg_filter.cu's algorithm in numpy on ``ts`` [R, C] f32 with
    ``plan`` (``csg_cuda.Plan``): per row a 32-bit mask a column of the
    hits before it, the alive mask, one pass over the nodes with
    popcount parities and the truth table on bits. The filtered table."""
    t = ts[:, plan.cols]
    cr = t.shape[1]
    k = np.arange(cr)
    bit = np.left_shift(np.uint64(1), k.astype(np.uint64))
    with np.errstate(invalid="ignore"):
        lt = t[:, :, None] < t[:, None, :]                  # [R, i, j]
        le = t[:, :, None] <= t[:, None, :]
    earlier = np.where(k[:, None] < k[None, :], le,
                       lt & (k[:, None] != k[None, :]))
    before = (earlier * bit[None, :, None]).sum(1).astype(np.uint64)
    alive = (np.isfinite(t) * bit).sum(1).astype(np.uint64)
    full = np.uint64((1 << cr) - 1)

    def parity_bits(masked):                               # [R, cr] -> [R]
        ones = np.array([[bin(int(x)).count("1") & 1 for x in row]
                         for row in masked], np.uint64)
        return (ones * bit).sum(1).astype(np.uint64)

    for op, under, left in zip(plan.ops, plan.under, plan.left):
        under, left = np.uint64(under), np.uint64(left)
        rel = under & alive
        in_l = parity_bits(before & (rel & left)[:, None])
        in_r = parity_bits(before & (rel & ~left & full)[:, None])
        if op == T.CSG_UNION:
            allowed = (left & ~in_r) | (~left & ~in_l)
        elif op == T.CSG_INTERSECT:
            allowed = (left & in_r) | (~left & in_l)
        else:
            allowed = (left & ~in_r) | (~left & in_l)
        alive = (rel & allowed) | (~rel & alive)
    keep = ((alive[:, None] >> k.astype(np.uint64)) & np.uint64(1)) == 1
    out = ts.copy()
    out[:, plan.cols] = np.where(keep, t, np.float32(np.inf))
    return out


def random_trees(rng, n):
    """``n`` random roots (cols, nodes, under_bits, left_bits, n_cols) of
    2 to 5 op nodes at widths 3 to 32, the first three 3, 16 and 32 wide,
    each in a table of 0 to 4 more columns."""
    for i in range(n):
        width = (3, 16, 32)[i] if i < 3 else int(rng.integers(3, 33))
        n_nodes = int(rng.integers(2, min(5, width - 1) + 1))
        n_cols = width + int(rng.integers(0, 5))
        yield (*random_tree(rng, n_nodes, width, n_cols), n_cols)
