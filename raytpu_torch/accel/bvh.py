"""Host BVH builders of the port: binned SAH and median split (a numpy
copy of ``raytpu/accel/bvh.py``: ``_build_binary`` :88, ``_median_split``
:142, ``_sah_split`` :159, ``_flatten`` :228, ``build_bvh`` :291,
``validate_bvh`` :325).

``RenderConfig.bvh_builder`` "sah" and "median" take these builders
(``accel.attach_bvh``). Their trees equal raytpu's bit for bit: the same
float64 binning and median, the same DFS threading into the skip-link
layout (nodes in DFS order, a box hit descends to ``i+1``, a miss jumps to
``miss[i]``, ``miss == node_count`` exits), and the same ``1e-6`` box
widening. The tree is the native builder's :class:`Bvh`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from raytpu_torch.accel.native import Bvh

__all__ = ["Bvh", "build_bvh", "validate_bvh"]

SAH_BINS = 16
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


# ---------------------------------------------------------------------------
# binary tree construction (intermediate representation)
# ---------------------------------------------------------------------------

class _Tree:
    """Growable binary-BVH arrays; children stored as (left, right) pairs,
    leaves as (start, end) ranges into the ``order`` permutation."""

    def __init__(self, n_tris: int):
        self.bmin: list = []
        self.bmax: list = []
        self.left: list = []   # -1 → leaf
        self.right: list = []
        self.start: list = []
        self.end: list = []
        self.order = np.arange(n_tris, dtype=np.int64)

    def add(self, bmin, bmax) -> int:
        self.bmin.append(bmin)
        self.bmax.append(bmax)
        self.left.append(-1)
        self.right.append(-1)
        self.start.append(0)
        self.end.append(0)
        return len(self.bmin) - 1


def _build_binary(
    tmin: np.ndarray,
    tmax: np.ndarray,
    cent: np.ndarray,
    leaf_size: int,
    method: str,
) -> _Tree:
    n = tmin.shape[0]
    tree = _Tree(n)
    # stack of (node_idx, lo, hi) over tree.order slices
    root = tree.add(
        tmin.min(axis=0) if n else np.zeros(3),
        tmax.max(axis=0) if n else np.zeros(3),
    )
    stack = [(root, 0, n)]
    while stack:
        node, lo, hi = stack.pop()
        idx = tree.order[lo:hi]
        bmin = tmin[idx].min(axis=0)
        bmax = tmax[idx].max(axis=0)
        tree.bmin[node] = bmin
        tree.bmax[node] = bmax
        count = hi - lo
        if count <= leaf_size:
            tree.start[node], tree.end[node] = lo, hi
            continue

        split = None
        if method == "sah":
            split = _sah_split(tmin, tmax, cent, idx)
        if split is None:
            split = _median_split(cent, idx)
        if split is None:  # all centroids identical → forced half split
            mid = count // 2
            part = np.arange(count) < mid
        else:
            part = split
        n_left = int(part.sum())
        if n_left == 0 or n_left == count:
            mid = count // 2
            part = np.arange(count) < mid
            n_left = mid

        # partition the permutation slice in place
        tree.order[lo:hi] = np.concatenate([idx[part], idx[~part]])
        mid_pos = lo + n_left
        l = tree.add(None, None)
        r = tree.add(None, None)
        tree.left[node], tree.right[node] = l, r
        stack.append((r, mid_pos, hi))
        stack.append((l, lo, mid_pos))
    return tree


def _median_split(cent: np.ndarray, idx: np.ndarray) -> Optional[np.ndarray]:
    c = cent[idx]
    ext = c.max(axis=0) - c.min(axis=0)
    axis = int(np.argmax(ext))
    if ext[axis] <= 0:
        return None
    med = np.median(c[:, axis])
    part = c[:, axis] < med
    if part.sum() in (0, len(idx)):
        # degenerate median (many equal values): split by order statistics
        half = len(idx) // 2
        order = np.argsort(c[:, axis], kind="stable")
        part = np.zeros(len(idx), bool)
        part[order[:half]] = True
    return part


def _sah_split(
    tmin: np.ndarray, tmax: np.ndarray, cent: np.ndarray, idx: np.ndarray
) -> Optional[np.ndarray]:
    """Binned surface-area-heuristic split; returns a boolean left-mask over
    ``idx`` or None when no split beats the leaf cost."""
    c = cent[idx]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    ext = cmax - cmin
    count = len(idx)

    best_cost = np.inf
    best = None
    leaf_cost = INTERSECT_COST * count

    for axis in range(3):
        if ext[axis] <= 0:
            continue
        scale = SAH_BINS * (1.0 - 1e-6) / ext[axis]
        bins = np.minimum(
            ((c[:, axis] - cmin[axis]) * scale).astype(np.int64), SAH_BINS - 1
        )
        # per-bin counts and AABBs
        counts = np.bincount(bins, minlength=SAH_BINS)
        bin_min = np.full((SAH_BINS, 3), np.inf)
        bin_max = np.full((SAH_BINS, 3), -np.inf)
        for k in range(3):
            np.minimum.at(bin_min[:, k], bins, tmin[idx, k])
            np.maximum.at(bin_max[:, k], bins, tmax[idx, k])

        # prefix/suffix sweep
        lmin = np.minimum.accumulate(bin_min, axis=0)
        lmax = np.maximum.accumulate(bin_max, axis=0)
        rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
        lcnt = np.cumsum(counts)
        rcnt = np.cumsum(counts[::-1])[::-1]

        def area(bmin, bmax):
            d = np.maximum(bmax - bmin, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        # split after bin b: left = bins ≤ b, right = bins > b
        la = area(lmin[:-1], lmax[:-1])
        ra = area(rmin[1:], rmax[1:])
        lc = lcnt[:-1]
        rc = rcnt[1:]
        valid = (lc > 0) & (rc > 0)
        cost = np.where(
            valid,
            TRAVERSAL_COST + INTERSECT_COST * (la * lc + ra * rc)
            / max(area(lmin[-1:], lmax[-1:])[0], 1e-30),
            np.inf,
        )
        b = int(np.argmin(cost))
        if cost[b] < best_cost:
            best_cost = cost[b]
            best = bins <= b

    if best is None or best_cost >= leaf_cost:
        # cost termination: the caller enforces the leaf-size bound by
        # falling back to a median split for oversized ranges
        return None
    return best


# ---------------------------------------------------------------------------
# DFS flatten with skip links
# ---------------------------------------------------------------------------

def _flatten(tree: _Tree, leaf_size: int) -> Bvh:
    n_nodes = len(tree.bmin)
    # subtree sizes via reverse topological order (children have larger ids
    # than parents is NOT guaranteed by our stack order — compute recursively
    # with an explicit stack)
    size = np.ones(n_nodes, dtype=np.int64)
    # post-order accumulate
    stack = [(0, False)]
    order_post = []
    while stack:
        node, processed = stack.pop()
        if processed:
            order_post.append(node)
            continue
        stack.append((node, True))
        if tree.left[node] >= 0:
            stack.append((tree.left[node], False))
            stack.append((tree.right[node], False))
    for node in order_post:
        if tree.left[node] >= 0:
            size[node] = 1 + size[tree.left[node]] + size[tree.right[node]]

    aabb_min = np.zeros((n_nodes, 3), np.float32)
    aabb_max = np.zeros((n_nodes, 3), np.float32)
    tri_first = np.full(n_nodes, -1, np.int32)
    tri_count = np.zeros(n_nodes, np.int32)
    miss = np.zeros(n_nodes, np.int32)

    tri_slots = []
    # DFS emit: (tree_node, miss_link)
    pos = 0
    stack = [(0, n_nodes)]
    while stack:
        node, miss_link = stack.pop()
        i = pos
        pos += 1
        aabb_min[i] = tree.bmin[node]
        aabb_max[i] = tree.bmax[node]
        miss[i] = miss_link
        if tree.left[node] < 0:  # leaf
            lo, hi = tree.start[node], tree.end[node]
            tri_first[i] = len(tri_slots)
            tri_count[i] = hi - lo
            tri_slots.extend(tree.order[lo:hi].tolist())
        else:
            l, r = tree.left[node], tree.right[node]
            right_pos = i + 1 + size[l]
            # children in DFS order: left at i+1 (miss → right), right at
            # right_pos (miss → our miss)
            stack.append((r, miss_link))
            stack.append((l, right_pos))
    assert pos == n_nodes

    return Bvh(
        aabb_min=aabb_min,
        aabb_max=aabb_max,
        tri_first=tri_first,
        tri_count=tri_count,
        miss=miss,
        tri_order=np.asarray(tri_slots, np.int32),
    )


def build_bvh(
    v0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    leaf_size: int = 4,
    method: str = "sah",
) -> Bvh:
    """Build a threaded BVH over triangles given as (v0, e1, e2) corner SoA.

    ``method``: "sah" (binned, default) or "median".
    """
    v1 = v0 + e1
    v2 = v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    tmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)
    cent = (tmin + tmax) * 0.5
    if v0.shape[0] == 0:
        return Bvh(
            aabb_min=np.zeros((1, 3), np.float32),
            aabb_max=np.zeros((1, 3), np.float32),
            tri_first=np.asarray([0], np.int32),
            tri_count=np.asarray([0], np.int32),
            miss=np.asarray([1], np.int32),
            tri_order=np.zeros((0,), np.int32),
        )
    tree = _build_binary(tmin, tmax, cent, leaf_size, method)
    bvh = _flatten(tree, leaf_size)
    # widen boxes a hair so float32 rounding never culls a real hit
    eps = 1e-6 * np.maximum(1.0, np.abs(bvh.aabb_max - bvh.aabb_min))
    return bvh._replace(aabb_min=(bvh.aabb_min - eps).astype(np.float32),
                        aabb_max=(bvh.aabb_max + eps).astype(np.float32))


def validate_bvh(bvh: Bvh, v0, e1, e2) -> None:
    """Structural invariants (SURVEY.md §4): every primitive exactly once;
    every leaf's triangles inside its AABB; skip links in-range and
    strictly forward (DFS property)."""
    m = bvh.num_nodes
    assert bvh.tri_order.shape[0] == v0.shape[0]
    assert np.array_equal(np.sort(bvh.tri_order), np.arange(v0.shape[0]))
    assert ((bvh.miss > np.arange(m)) & (bvh.miss <= m)).all()
    v1, v2 = v0 + e1, v0 + e2
    for i in range(m):
        if bvh.tri_first[i] < 0:
            continue
        sl = bvh.tri_order[bvh.tri_first[i] : bvh.tri_first[i] + bvh.tri_count[i]]
        for p in sl:
            for corner in (v0[p], v1[p], v2[p]):
                assert (corner >= bvh.aabb_min[i] - 1e-4).all(), (i, p)
                assert (corner <= bvh.aabb_max[i] + 1e-4).all(), (i, p)
