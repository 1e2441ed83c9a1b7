"""LBVH of the port: the Morton-code radix BVH built on the scene's device
(counterpart of ``raytpu/accel/lbvh.py``).

Steps 1-4 run in PyTorch on ``device`` (the card by default, whole-tensor
ops; no Pallas kernel is involved, so PyTorch ops are the port here):

1. 30-bit Morton codes of the triangle centroids (:func:`morton_codes`,
   ``lbvh.py:44``; the quantisation is a subtract, a divide and a multiply,
   each rounded once, so no FMA can enter);
2. a stable argsort of the codes (``jnp.argsort`` is stable; equal codes
   are common on the generated meshes);
3. the Karras binary radix tree (:func:`build_radix_tree`, :59): each
   internal node's range and split by fixed-step binary searches over
   common-prefix lengths, 32, 33 and 33 steps as in raytpu;
4. the bottom-up box refit (:func:`refit_aabbs`, :136) by 64 fixed sweeps.

The threading into the skip-link layout stays vectorized numpy
(:199-266). Meshes of at most ``max(1, leaf_size)`` triangles take the SAH
builder, as raytpu's do (:178-181). The tree equals raytpu's
``build_lbvh`` bit for bit. LBVH trees build faster and trace slower than
binned SAH (raytpu's note, :21-23).
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.accel.native import Bvh

__all__ = ["build_lbvh", "build_radix_tree", "morton_codes", "refit_aabbs"]


def _expand_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (Morton interleave, :35)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(cent: torch.Tensor) -> torch.Tensor:
    """(T, 3) f32 centroids -> (T,) int32 30-bit Morton codes, normalized
    to the centroid box (:44)."""
    lo = cent.min(dim=0).values
    hi = cent.max(dim=0).values
    ext = torch.clamp_min(hi - lo, 1e-30)
    q = torch.clamp(((cent - lo) / ext) * 1023.0, 0, 1023).to(torch.int32)
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def _clz(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the 32-bit pattern of positive int32 ``x``
    (``jax.lax.clz``), by a 5-step binary search of shifts and compares in
    int64 (no float ``log2``, which rounds near powers of two)."""
    x = x.to(torch.int64)
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - s))       # the top s bits are zero
        n = torch.where(small, n + s, n)
        x = torch.where(small, x << s, x)
    return n.to(torch.int32)


def build_radix_tree(codes_sorted: torch.Tensor):
    """Karras-style binary radix tree over sorted int32 Morton codes (:59).

    Returns ``(left, right, lo, hi)`` int32 for the N-1 internal nodes:
    ``0 <= c < N`` encodes leaf ``c``, ``c >= N`` internal ``c - N``; each
    internal node covers the sorted leaves ``[lo, hi]``. Duplicate codes are
    told apart by index (the augmented key)."""
    n = codes_sorted.shape[0]
    i32 = torch.int32
    idx = torch.arange(n - 1, dtype=i32, device=codes_sorted.device)

    def delta(i, j):
        """Common-prefix length of the augmented keys; -1 out of range."""
        valid = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        diff = codes_sorted[i.long()] ^ codes_sorted[jc.long()]
        d = torch.where(diff == 0, 32 + _clz(torch.clamp_min(i ^ jc, 1)),
                        _clz(torch.clamp_min(diff, 1)))
        return torch.where(valid, d, torch.full_like(d, -1))

    def half(t):
        return torch.div(t, 2, rounding_mode="floor")

    d_dir = torch.sign(delta(idx, idx + 1) - delta(idx, idx - 1)).to(i32)
    d_dir = torch.where(d_dir == 0, torch.ones_like(d_dir), d_dir)
    delta_min = delta(idx, idx - d_dir)

    # range length upper bound: exponential search, 32 fixed steps (:95)
    lmax = torch.full_like(idx, 2)
    for _ in range(32):
        grow = delta(idx, idx + lmax * d_dir) > delta_min
        lmax = torch.where(grow, lmax * 2, lmax)

    # binary search of the range's other end, 33 fixed steps (:105)
    l = torch.zeros_like(idx)
    t = lmax
    for _ in range(33):
        t = torch.clamp_min(half(t), 0)
        ok = (t > 0) & (delta(idx, idx + (l + t) * d_dir) > delta_min)
        l = torch.where(ok, l + t, l)
    j = idx + l * d_dir

    # the split: binary search on the node's own prefix, 33 steps (:120)
    delta_node = delta(idx, j)
    s = torch.zeros_like(idx)
    t = l
    for _ in range(33):
        t = half(t + 1)
        ok = (s + t < l) & (delta(idx, idx + (s + t) * d_dir) > delta_node)
        s = torch.where(ok, s + t, s)
        t = torch.where(t > 1, t, torch.zeros_like(t))
    gamma = idx + s * d_dir + torch.clamp_max(d_dir, 0)

    lo = torch.minimum(idx, j)
    hi = torch.maximum(idx, j)
    left = torch.where(lo == gamma, gamma, gamma + n)
    right = torch.where(hi == gamma + 1, gamma + 1, gamma + 1 + n)
    return left, right, lo, hi


def refit_aabbs(left, right, leaf_min, leaf_max):
    """Bottom-up box refit by 64 fixed sweeps (:136; a radix tree over
    30+32-bit keys is at most 64 deep): each sweep takes every internal
    node's box from its children's, leaves from ``leaf_min``/``leaf_max``."""
    n = leaf_min.shape[0]
    m = n - 1
    node_min = torch.full((m, 3), float("inf"), dtype=torch.float32,
                          device=leaf_min.device)
    node_max = torch.full((m, 3), float("-inf"), dtype=torch.float32,
                          device=leaf_min.device)
    sides = []
    for c in (left, right):
        is_leaf = (c < n)[:, None]
        sides.append((is_leaf, torch.clamp(c, 0, n - 1).long(),
                      torch.clamp(c - n, 0, m - 1).long()))

    def child_box(side):
        is_leaf, ci, ii = side
        return (torch.where(is_leaf, leaf_min[ci], node_min[ii]),
                torch.where(is_leaf, leaf_max[ci], node_max[ii]))

    for _ in range(64):
        (lmin, lmax), (rmin, rmax) = child_box(sides[0]), child_box(sides[1])
        node_min, node_max = torch.minimum(lmin, rmin), torch.maximum(lmax, rmax)
    return node_min, node_max


def device_steps(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, device):
    """Steps 1-4 on ``device``: ``(order, left, right, lo, hi, node_min,
    node_max, tmin, tmax)`` as tensors there (``tmin``/``tmax`` the
    triangles' boxes in prim order)."""
    v0t, e1t, e2t = (torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                     device=device) for a in (v0, e1, e2))
    v1 = v0t + e1t
    v2 = v0t + e2t
    tmin = torch.minimum(torch.minimum(v0t, v1), v2)
    tmax = torch.maximum(torch.maximum(v0t, v1), v2)
    cent = (tmin + tmax) * 0.5
    codes = morton_codes(cent)
    order = torch.argsort(codes, stable=True)
    left, right, lo, hi = build_radix_tree(codes[order])
    node_min, node_max = refit_aabbs(left, right, tmin[order], tmax[order])
    return order, left, right, lo, hi, node_min, node_max, tmin, tmax


def thread(steps, leaf_size: int) -> Bvh:
    """The skip-link layout of the radix tree of :func:`device_steps`
    (``build_lbvh`` :199-266, vectorized numpy): every node covers a
    contiguous sorted-leaf range [lo, hi], so DFS order is a lexsort by (lo
    ascending, size descending) and each skip link is the first later node
    with lo > hi; subtrees of at most ``leaf_size`` triangles collapse into
    packed leaves."""
    order, left, right, lo_i, hi_i, node_min, node_max, tmin, tmax = (
        x.cpu().numpy() for x in steps)
    n = order.shape[0]
    left_np = left.astype(np.int64)
    right_np = right.astype(np.int64)
    lo_i = lo_i.astype(np.int64)                 # (n-1,) internal ranges
    hi_i = hi_i.astype(np.int64)
    order_np = order.astype(np.int64)
    lmin = tmin[order_np]
    lmax = tmax[order_np]

    count_i = hi_i - lo_i + 1                    # (n-1,)
    # parent's triangle count for every node (encoded: leaf c<n, internal
    # n+i), via one scatter; the root has no parent (count = n+1 sentinel)
    pcount = np.full(2 * n - 1, n + 1, np.int64)
    pcount[left_np] = count_i
    pcount[right_np] = count_i

    # emitted nodes: interior (count > leaf_size), collapsed-leaf internal
    # nodes (count <= leaf_size, topmost: parent count > leaf_size), and
    # original leaves whose parent was not collapsed
    int_keep = count_i > leaf_size
    int_leaf = (~int_keep) & (pcount[n:] > leaf_size)
    leaf_keep = pcount[:n] > leaf_size

    lo_all = np.concatenate([lo_i[int_keep], lo_i[int_leaf],
                             np.arange(n)[leaf_keep]])
    hi_all = np.concatenate([hi_i[int_keep], hi_i[int_leaf],
                             np.arange(n)[leaf_keep]])
    is_leaf = np.concatenate([np.zeros(int_keep.sum(), bool),
                              np.ones(int_leaf.sum() + leaf_keep.sum(), bool)])
    bmin_all = np.concatenate([node_min[int_keep], node_min[int_leaf],
                               lmin[leaf_keep]])
    bmax_all = np.concatenate([node_max[int_keep], node_max[int_leaf],
                               lmax[leaf_keep]])

    # DFS order: ranges nest, parents share lo with their leftmost
    # descendant and are strictly larger -> (lo asc, size desc)
    dfs = np.lexsort((-(hi_all - lo_all), lo_all))
    lo_s = lo_all[dfs]
    hi_s = hi_all[dfs]
    # skip link = first later node outside the subtree: lo is
    # non-decreasing in DFS order, so it is searchsorted(lo, hi+1)
    miss = np.searchsorted(lo_s, hi_s + 1, side="left").astype(np.int32)

    leaf_s = is_leaf[dfs]
    tri_first = np.where(leaf_s, lo_s, -1).astype(np.int32)
    tri_count = np.where(leaf_s, hi_s - lo_s + 1, 0).astype(np.int32)

    eps = 1e-6 * np.maximum(1.0, np.abs(bmax_all[dfs] - bmin_all[dfs]))
    return Bvh(
        aabb_min=(bmin_all[dfs] - eps).astype(np.float32),
        aabb_max=(bmax_all[dfs] + eps).astype(np.float32),
        tri_first=tri_first,
        tri_count=tri_count,
        miss=miss,
        tri_order=order_np.astype(np.int32),
    )


def build_lbvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
               leaf_size: int = 4, device="cuda") -> Bvh:
    """LBVH of one mesh given as corner + edges: steps 1-4 on ``device``
    (:func:`device_steps`), the threading on the host (:func:`thread`)."""
    if int(v0.shape[0]) <= max(1, leaf_size):
        from raytpu_torch.accel.bvh import build_bvh

        return build_bvh(v0, e1, e2, leaf_size=leaf_size)
    return thread(device_steps(v0, e1, e2, device), leaf_size)
