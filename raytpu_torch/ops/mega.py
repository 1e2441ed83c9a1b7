"""Culling prepass of the per-lane and consensus tiers, and their link
tables (counterpart of ``raytpu/ops/mega.py:125-317`` and ``:347-554``).

Per sweep, the rays of a wave are grouped into blocks of ``BLOCK_PACKETS``
packets, relative to the wave's first packet. Each block is reduced to one
row of ``STATS_W`` values (:func:`block_stats_ref`); :func:`chunk_block_hits`
turns the rows into a conservative (entry, block) hit bitmask, each block's
majority direction octant and each entry's mean entry depth;
:func:`entry_perm` orders the entries. The per-lane sweeps
(``ops/perlane.py``) skip the entries a lane's block misses and walk each
entry near child first with the block's octant, along the links
:func:`octant_links` threads per octant; the consensus sweeps
(``ops/consensus.py``) walk the same schedule along the wide links
:func:`mesh_wide_links` makes of them (:func:`widen_octant_links`, with the
treelet roots of :func:`treelet_partition` kept).

On the card the whole schedule is one launch of K7 (``csrc/mega.cu``,
:func:`block_schedule`): its CTAs reduce the blocks and test them against
the entries' world root boxes, and the last CTA to finish packs the bits
and orders the entries; the host allocates the outputs and enqueues that
launch, with no PyTorch kernel and no sync. The plain PyTorch versions
(:func:`block_stats_ref`, :func:`chunk_block_hits`, :func:`entry_perm`, as
the JAX package's plain XLA, with :func:`world_root_boxes`) run on the CPU
and are the kernel's oracle. The bitmask is int32 bit patterns of the JAX
package's u32 words (PyTorch has no full u32); bit 31 is the sign bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch import _build

# packets per culling block: 8 packets of 1024 lanes = two 32x32 tiles at
# 4 spp (raytpu/ops/mega.py:77)
BLOCK_PACKETS = 8
OCTANTS = 8
# per-block stats row: o_lo(3) o_hi(3) d_lo(3) d_hi(3) t_hi neg(3) n_live
STATS_W = 17
BIG = 3e38  # the prepass's +-infinity sentinel (mega.py:368)


def octant_links(aabb_min: np.ndarray, aabb_max: np.ndarray,
                 first: np.ndarray, miss: np.ndarray):
    """Per-octant near-child-first threadings of one flat DFS tree
    (``raytpu/ops/mega.py:128``): for octant ``o`` (bit ``a`` set = the ray
    direction is negative along axis ``a``) a hit on interior node ``n``
    continues at ``succ[o, n]`` (its near child), a miss or a finished leaf
    at ``skip[o, n]``; ``M`` ends the walk. Returns ``(succ, skip)``, each
    (8, M) int32 with mesh-local node ids, like ``bvh_miss``."""
    m = first.shape[0]
    interior = first < 0
    octs = np.arange(OCTANTS)
    if m == 1 or not interior.any():
        succ = np.tile(miss.astype(np.int64), (OCTANTS, 1))
        return succ.astype(np.int32), succ.astype(np.int32).copy()

    ids = np.arange(m)
    left = ids + 1                       # DFS: left child follows parent
    # right child = left child's skip link (its next sibling)
    right = np.where(interior, miss[np.clip(left, 0, m - 1)], 0)
    center = (aabb_min.astype(np.float64) + aabb_max) * 0.5
    ii = ids[interior]
    l, r = left[ii], right[ii]
    delta = center[r] - center[l]                      # (I, 3)
    axis = np.argmax(np.abs(delta), axis=1)
    left_lower = np.take_along_axis(delta, axis[:, None], axis=1)[:, 0] >= 0
    neg = ((octs[:, None] >> axis[None, :]) & 1).astype(bool)  # (8, I)
    pick_l = left_lower[None, :] ^ neg
    near = np.where(pick_l, l[None, :], r[None, :])    # (8, I)
    far = np.where(pick_l, r[None, :], l[None, :])

    # skip[near(i)] = far(i); skip[far(i)] = skip[i]; skip[root] = M. The
    # far chains resolve by pointer doubling.
    skip = np.full((OCTANTS, m), -1, np.int64)
    skip[:, 0] = m
    skip[octs[:, None], near] = far
    rf = np.zeros((OCTANTS, m), np.int64)   # resolve-from (far -> parent)
    pend = np.zeros((OCTANTS, m), bool)
    rf[octs[:, None], far] = ii[None, :]
    pend[octs[:, None], far] = True
    for _ in range(2 * int(np.ceil(np.log2(m))) + 2):
        if not pend.any():
            break
        val = np.take_along_axis(skip, rf, axis=1)
        src_pend = np.take_along_axis(pend, rf, axis=1)
        newly = pend & ~src_pend
        skip = np.where(newly, val, skip)
        pend = pend & src_pend
        rf = np.take_along_axis(rf, rf, axis=1)
    assert not pend.any() and (skip >= 0).all()

    succ = skip.copy()                     # leaves: succ == skip
    succ[:, ii] = near
    return succ.astype(np.int32), skip.astype(np.int32)


def mesh_octant_links(aabb_min, aabb_max, first, miss, node_ranges):
    """:func:`octant_links` of every traversal mesh of the concatenated
    ``bvh_*`` arrays, side by side: ``(succ, skip)``, each (8, M) int32."""
    pairs = [octant_links(aabb_min[b:b + n], aabb_max[b:b + n],
                          first[b:b + n], miss[b:b + n])
             for b, n in node_ranges]
    return tuple(np.ascontiguousarray(np.concatenate(x, axis=1))
                 for x in zip(*pairs))


# the per-lane tier's treelet size cap (raytpu/ops/perlane.py:106): the
# wide links keep the treelet roots that cap defines
NODE_CAP = 127
# interior levels kept by the wide links: every other one, a stackless BVH4
# (raytpu/ops/mega.py:268-276, MEGA_WIDE_STRIDE)
WIDE_STRIDE = 2


def treelet_partition(first: np.ndarray, miss: np.ndarray):
    """Greedy DFS cut of one flat skip-link tree into subtrees of at most
    ``NODE_CAP`` nodes (``raytpu/ops/perlane.py:215``): the subtree of node
    ``i`` spans ``[i, miss[i])``. Returns ``(tid, n_treelets)``, ``tid[i]``
    the treelet of node ``i`` or ``n_treelets`` for top-tree nodes."""
    n = first.shape[0]
    span = miss - np.arange(n)
    tid = np.full(n, -1, np.int64)
    nt = 0
    i = 0
    while i < n:
        if span[i] <= NODE_CAP:
            tid[i:miss[i]] = nt
            nt += 1
            i = miss[i]
        else:
            i += 1            # too big: a top node, descend
    top = tid < 0
    tid[top] = nt
    assert not (top & (first >= 0)).any(), "leaf in top tree"
    return tid, nt


def widen_octant_links(succ: np.ndarray, skip: np.ndarray, first: np.ndarray,
                       miss: np.ndarray, keep_extra: np.ndarray = None):
    """Wide rethreading of one tree's per-octant links for the consensus
    walk (``raytpu/ops/mega.py:198``): every interior node whose depth is
    not a multiple of ``WIDE_STRIDE`` (and not in ``keep_extra``) leaves each
    octant's threading, so a hit on a kept interior node continues at the
    next kept node of the octant's preorder, its grandchild level. Leaves
    stay, with their own box tests, and keep their preorder. Dropped nodes
    get terminator links (they are unreachable). Returns ``(succ, skip)``,
    each (8, n) int32.

    The same values as raytpu's; the sequential parts (depths, the always-
    hit walk) loop over Python lists and the rest is vectorized, so a tree
    of 75,890 nodes threads in a fraction of a second."""
    n = first.shape[0]
    leaf = first >= 0
    par = np.full(n, -1, np.int64)
    ii = np.flatnonzero(~leaf)
    if ii.size:
        par[ii + 1] = ii
        par[np.minimum(miss[ii + 1], n - 1)] = ii
    par_l = par.tolist()
    depth = [0] * n
    for i in range(1, n):
        if par_l[i] >= 0:
            depth[i] = depth[par_l[i]] + 1
    retained = leaf | (np.asarray(depth, np.int64) % WIDE_STRIDE == 0)
    if keep_extra is not None:
        retained |= keep_extra
    pref = np.concatenate([[0], np.cumsum(retained)])
    out_succ = np.full_like(succ, n)
    out_skip = np.full_like(skip, n)
    for o in range(OCTANTS):
        # the octant's preorder: the always-hit walk, every node once
        step = np.where(leaf, skip[o], succ[o]).tolist()
        order = [0] * n
        x = 0
        for k in range(n):
            order[k] = x
            x = step[x]
        assert x == n
        order = np.asarray(order, np.int64)
        filt = order[retained[order]]
        # the first kept node after each kept node's subtree
        j = np.arange(filt.size) + pref[miss[filt]] - pref[filt]
        tgt_skip = np.where(j < filt.size, filt[np.minimum(j, filt.size - 1)], n)
        out_skip[o, filt] = tgt_skip
        # an interior subtree holds kept leaves: its next kept node in
        # preorder lies inside it
        out_succ[o, filt] = np.where(leaf[filt], tgt_skip,
                                     np.append(filt[1:], n))
    return out_succ.astype(np.int32), out_skip.astype(np.int32)


def mesh_wide_links(succ, skip, first, miss, node_ranges):
    """:func:`widen_octant_links` of every traversal mesh's slice of the
    (8, M) octant links ``succ``/``skip`` (:func:`mesh_octant_links`),
    keeping each mesh's treelet roots threaded, as ``pack_mega_tables``
    does (``raytpu/ops/mega.py:304-317``), side by side: ``(succ, skip)``,
    each (8, M) int32, mesh-local like ``bvh_miss``."""
    pairs = []
    for b, n in node_ranges:
        f, m = first[b:b + n], miss[b:b + n]
        tid, nt = treelet_partition(f, m)
        roots = (tid < nt) & np.concatenate([[True], tid[1:] != tid[:-1]])
        pairs.append(widen_octant_links(succ[:, b:b + n], skip[:, b:b + n],
                                        f, m, keep_extra=roots))
    return tuple(np.ascontiguousarray(np.concatenate(x, axis=1))
                 for x in zip(*pairs))


def check_blocks(kernel: str, p: int) -> None:
    if p % BLOCK_PACKETS:
        raise ValueError(f"{kernel}: {p} packets are not whole blocks of "
                         f"{BLOCK_PACKETS}")


# ---------------------------------------------------------------------------
# K7: per-block stats and the schedule made from them
# ---------------------------------------------------------------------------

# entry orders, as the C entry point numbers them
ORDERS = ("origin", "light")


class BlockSchedule(NamedTuple):
    """What one :func:`block_schedule` launch writes: the schedule the
    culled sweeps take (``bits`` (E, ceil(PB/32)) int32 and ``entries``
    (E, 5) int32 in walk order, ``octs`` (PB,) int32), the stats rows
    (PB, ``STATS_W``) f32 and each entry's sort ``keys`` (E,) f32 in build
    order (the mean entry depth for "origin", the squared distance from
    the light for "light")."""
    bits: torch.Tensor
    octs: torch.Tensor
    entries: torch.Tensor
    stats: torch.Tensor
    keys: torch.Tensor


def schedule_buffers(n_entries: int, n_blocks: int, device):
    """The outputs and scratch of one :func:`block_schedule` launch, views
    of one int32 allocation: ``(bits, octs, rows, ranks, arrived, stats,
    keys, enter)``, the last three f32 (``enter`` (E, PB) the per-block
    entry distances)."""
    e, pb = n_entries, n_blocks
    words = -(-pb // 32)
    ints = (e * words, pb, e * 5, e, 1)
    floats = (pb * STATS_W, e, e * pb)
    buf = torch.empty(sum(ints) + sum(floats), dtype=torch.int32, device=device)
    head, tail = buf.split([sum(ints), sum(floats)])
    bits, octs, rows, ranks, arrived = head.split(ints)
    stats, keys, enter = tail.view(torch.float32).split(floats)
    return (bits.view(e, words), octs, rows.view(e, 5), ranks, arrived,
            stats.view(pb, STATS_W), keys, enter.view(e, pb))


def block_schedule(ts, rays: torch.Tensor, window: torch.Tensor, tmin: float,
                   order: str) -> BlockSchedule:
    """The culling prepass of ``rays`` (6, P, K) on the card, in one K7
    launch: the stats rows of the lanes with ``window`` (P, K) above
    ``tmin``, one per block of 8 packets (:func:`block_stats_ref`'s), then
    the bits and octants of :func:`chunk_block_hits` and the entries in
    :func:`entry_perm`'s ``order``, all equal to the plain versions' bit
    for bit (the "origin" keys round apart from PyTorch's sum). CUDA
    tensors only; the host allocates and enqueues the launch, with no
    other kernel and no sync."""
    k = "block_stats"
    if order not in ORDERS:
        raise ValueError(f"entry order {order!r}: use 'origin' or 'light'")
    p = rays.shape[1]
    check_blocks(k, p)
    pb = p // BLOCK_PACKETS
    e = ts.entries.shape[0]
    m = ts.bvh_aabb_min.shape[0]
    bits, octs, rows, ranks, arrived, stats, keys, enter = schedule_buffers(
        e, pb, rays.device)
    c = _build.check_operand
    ptr = _build.Pointer
    light = ts.light[:3] if order == "light" else (0.0, 0.0, 0.0)
    _build.launch(
        k,
        *_build.check_planes(k, "rays", rays, (6, *rays.shape[1:])),
        c(k, "window", window, rays.shape[1:]),
        pb, BLOCK_PACKETS * rays.shape[2], float(tmin), ptr(stats),
        e, bits.shape[1], ORDERS.index(order), *light,
        c(k, "entries", ts.entries, (e, 5), torch.int32),
        c(k, "o2w", ts.o2w, (ts.o2w.shape[0], 3, 4)),
        c(k, "bvh_aabb_min", ts.bvh_aabb_min, (m, 3)),
        c(k, "bvh_aabb_max", ts.bvh_aabb_max, (m, 3)),
        ptr(bits), ptr(octs), ptr(rows), ptr(keys), ptr(ranks), ptr(enter),
        ptr(arrived),
    )
    return BlockSchedule(bits, octs, rows, stats, keys)


def block_stats_ref(rays: torch.Tensor, window: torch.Tensor,
                    tmin: float) -> torch.Tensor:
    """(P/8, ``STATS_W``) f32 stats of ``rays`` (6, P, K) over the lanes
    with ``window`` (P, K) above ``tmin``, one row per block of 8 packets,
    in plain PyTorch: the reductions of
    ``_block_stats_kernel`` (``raytpu/ops/mega.py:360``): dead lanes take
    the +-3e38 sentinels, ``t_hi`` is at least 0, the counts are exact."""
    p = rays.shape[1]
    check_blocks("block_stats", p)
    pb = p // BLOCK_PACKETS
    r = rays.reshape(6, pb, -1)
    w = window.reshape(pb, -1)
    live = w > tmin
    lo = torch.where(live, r, BIG).amin(dim=2).T           # (PB, 6)
    hi = torch.where(live, r, -BIG).amax(dim=2).T
    t_hi = torch.where(live, w, 0.0).amax(dim=1, keepdim=True)
    neg = (live & (r[3:] < 0)).sum(dim=2).T.float()        # (PB, 3)
    n_live = live.sum(dim=1, keepdim=True).float()
    return torch.cat([lo[:, :3], hi[:, :3], lo[:, 3:], hi[:, 3:], t_hi, neg,
                      n_live], dim=1)


# ---------------------------------------------------------------------------
# the prepass on the stats rows, plain PyTorch (the kernel's oracle)
# ---------------------------------------------------------------------------

def world_root_boxes(ts):
    """Per entry: its mesh root box (the entry's node ``node_base``) through
    the instance's object-to-world transform, by the |linear| rule
    (``raytpu/ops/mega.py:424``). Returns ``(lo, hi)``, each (E, 3)."""
    nb = ts.entries[:, 2].long()
    lo, hi = ts.bvh_aabb_min[nb], ts.bvh_aabb_max[nb]
    m = ts.o2w[ts.entries[:, 0].long()]                    # (E, 3, 4)
    # centre through the linear part, half extent through its |.|, at once
    lin = torch.stack([m[:, :, :3], m[:, :, :3].abs()])     # (2, E, 3, 3)
    ch = torch.stack([(lo + hi) * 0.5, (hi - lo) * 0.5])[:, :, None, :]
    x = lin * ch                                           # (2, E, 3, 3)
    cw, hw = x[..., 0] + x[..., 1] + x[..., 2]             # (E, 3) each
    cw = cw + m[:, :, 3]
    return cw - hw, cw + hw


def _pack_bits(hit: torch.Tensor) -> torch.Tensor:
    """(E, PB) bool -> (E, ceil(PB/32)) int32 words, bit ``b % 32`` of word
    ``b // 32`` for block ``b`` (the u32 words of ``mega.py:526-531``)."""
    e, pb = hit.shape
    pad = (-pb) % 32
    if pad:
        hit = torch.cat([hit, hit.new_zeros((e, pad))], dim=1)
    word_bit = torch.arange(32, device=hit.device)
    words = (hit.reshape(e, -1, 32).long() << word_bit).sum(dim=2)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def chunk_block_hits(ts, rays: torch.Tensor, window: torch.Tensor,
                     tmin: float):
    """Conservative (entry, block) culling (``raytpu/ops/mega.py:449``).
    Returns ``(bits, octs, depth)``:

    * ``bits`` (E, ceil(PB/32)) int32: interval-arithmetic slab test of each
      block's ray bounds against each entry's world root box, never false
      negative (a sign-spanning direction interval widens to +-3e38);
    * ``octs`` (PB,) int32: each block's majority direction octant;
    * ``depth`` (E,) f32: the mean conservative entry distance over the
      entry's hit blocks.

    The stats rows come from :func:`block_stats_ref`, the entries' world
    root boxes from :func:`world_root_boxes`. The interval arithmetic runs
    with the axes and the two box bounds stacked, so its op count does not
    grow with the axes."""
    stats = block_stats_ref(rays, window, tmin)            # (PB, 17)
    o_lo, o_hi = stats[:, 0:3], stats[:, 3:6]
    d_lo, d_hi = stats[:, 6:9], stats[:, 9:12]
    n_live = stats[:, 16]
    neg_maj = (stats[:, 13:16] * 2 > n_live[:, None]).int()
    axis_bit = torch.arange(3, dtype=torch.int32, device=stats.device)
    octs = (neg_maj << axis_bit).sum(dim=1, dtype=torch.int32)

    box_lo, box_hi = world_root_boxes(ts)
    # interval reciprocal of [d_lo, d_hi]: sign-spanning -> (-big, big)
    spans = (d_lo <= 0.0) & (d_hi >= 0.0)                  # (PB, 3)
    inv_a = torch.where(spans, -BIG, 1.0 / torch.where(spans, 1.0, d_lo))
    inv_b = torch.where(spans, BIG, 1.0 / torch.where(spans, 1.0, d_hi))
    il = torch.minimum(inv_a, inv_b)
    ih = torch.maximum(inv_a, inv_b)
    # (bound - o) * inv over interval endpoints, for both box bounds at once:
    # (2, E, PB, 3)
    bound = torch.stack([box_lo, box_hi])[:, :, None, :]
    num_lo = bound - o_hi
    num_hi = bound - o_lo
    cands = torch.stack([num_lo * il, num_lo * ih, num_hi * il, num_hi * ih])
    s_lo = cands.amin(dim=0).amin(dim=0)                   # (E, PB, 3)
    s_hi = cands.amax(dim=0).amax(dim=0)
    enter_lo = torch.clamp_min(s_lo.amax(dim=2), tmin)     # (E, PB)
    exit_hi = torch.minimum(s_hi.amin(dim=2), stats[:, 12])
    hit = (enter_lo <= exit_hi) & (n_live > 0)

    n_hit = hit.sum(dim=1).float()
    depth = torch.where(hit, torch.clamp_min(enter_lo, 0.0), 0.0).sum(dim=1) \
        / torch.clamp_min(n_hit, 1.0)
    return _pack_bits(hit), octs, depth


def entry_perm(ts, depth: torch.Tensor, order: str = "origin") -> torch.Tensor:
    """Sweep entry order (``raytpu/ops/mega.py:535``), a stable argsort so
    that exactly tied entries keep build order:

    * ``"origin"``: ascending entry depth (the closest sweep's order);
    * ``"light"``: ascending squared distance from the point light to the
      entry's world root box (the shadow sweep's default: occluders near
      the light end the most walks first).
    """
    if order == "light":
        lo, hi = world_root_boxes(ts)
        lp = ts.light_pos[None, :]
        sq = (torch.minimum(torch.maximum(lp, lo), hi) - lp).square()
        return torch.argsort(sq[:, 0] + sq[:, 1] + sq[:, 2], stable=True)
    if order != "origin":
        raise ValueError(f"entry order {order!r}: use 'origin' or 'light'")
    return torch.argsort(depth, stable=True)
