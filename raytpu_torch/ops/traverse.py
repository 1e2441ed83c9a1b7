"""Closest-hit and any-hit sweeps on the packed ABI (counterpart of
``raytpu/ops/traverse.py`` and ``raytpu/ops/traverse_pallas.py:459-799``),
and the one-mesh walks of the per-(instance, mesh) loop
(``traverse_pallas.py:115-442``).

Packed ABI, as in the JAX package: rays are one (6, P, K) f32 tensor
(origin xyz, direction xyz), the trace state one (9, P, K) f32 tensor in
``ST_*`` plane order with valid/mat/inst carried as int32 bit patterns.

``closest_sweep`` / ``anyhit_sweep`` are the kernel wrappers: a CPU tensor
takes the plain version beside them, a CUDA tensor launches the kernel in
``csrc/traverse.cu`` (or raises). K10a (``closest_sweep``) and K10b
(``anyhit_sweep``) read the scene's packed records (``packed_nodes``,
``packed_tris``) with ``bvh_miss``. Rays and state may be waves
``x[:, s:s+b]`` of larger buffers: the kernels take a plane stride and the
plain versions read and write through the view. The plain versions walk the same tables
the same way: per lane, the entries in ``traversal_list`` order, a
skip-link walk from node 0 to ``node_count`` that tests a leaf's triangles
on arrival and descends an inner node when the ``_slab`` test hits within
``(tmin, best_t)``. Lanes still walking are compacted every step, so dead
and finished lanes cost nothing.

``mesh_closest`` / ``mesh_anyhit`` (K11a, K11b) walk ONE mesh's tree for
rays already in its object space, with no transform and no merge: the
function of ``pallas_closest`` / ``pallas_anyhit``, which the JAX package's
per-(instance, mesh) loop runs per entry (``raytpu/ops/trace.py:256-322``,
:429-459; ``ops/trace.py`` here). Their outputs are unpacked as the Pallas
wrappers' are: t (``BIG_T`` on a miss), the mesh-local slot (-1 on a miss;
:func:`slot_to_prim`), u, v and the object normal ((0, 0, 1) on a miss), or
the occlusion flags. Groups of :data:`WARP` consecutive lanes walk as one,
as the TPU's packet of 1024 does: the group descends, or tests a leaf, where
any of its lanes' boxes hits. K11a and K11b read the packed records with
``bvh_miss``, as K10a and K10b do. The kernels are in
``csrc/traverse.cu``.
"""

from __future__ import annotations

import torch

from raytpu_torch import _build
from raytpu_torch.device_scene import TorchScene
from raytpu_torch.ops.intersect import BIG_T, moller_trumbore, safe_inverse, slab

ST_T, ST_VALID, ST_MAT, ST_INST = 0, 1, 2, 3
ST_NX, ST_NY, ST_NZ, ST_U, ST_V = 4, 5, 6, 7, 8
WARP = 32  # lanes that walk one node pointer in the consensus walks: a warp


def pack_rays(o, d) -> torch.Tensor:
    """Vec3 (P, K) x2 -> one (6, P, K) buffer."""
    return torch.stack((*o, *d), dim=0)


def make_trace_state(lane_tmax: torch.Tensor) -> torch.Tensor:
    """Fresh (9, P, K) state: t = the lane window (0 = dead lane),
    inst = -1, nz = 1, everything else 0 (traverse_pallas.py:477-489)."""
    state = torch.zeros((9, *lane_tmax.shape), dtype=torch.float32,
                        device=lane_tmax.device)
    state[ST_T] = lane_tmax
    state[ST_INST] = torch.tensor(-1, dtype=torch.int32).view(torch.float32)
    state[ST_NZ] = 1.0
    return state


def unpack_state(state: torch.Tensor):
    """Packed state -> (t, valid bool, mat, inst, n Vec3, u, v)."""
    i32 = state[ST_VALID:ST_INST + 1].view(torch.int32)
    return (
        state[ST_T], i32[0] != 0, i32[1], i32[2],
        (state[ST_NX], state[ST_NY], state[ST_NZ]), state[ST_U], state[ST_V],
    )


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _entries_w2o(kernel: str, ts: TorchScene):
    """Validated ``(entries, E, w2o)``: the entry table, its row count and
    the instances' world-to-object transforms."""
    e = ts.entries.shape[0]
    c = _build.check_operand
    return (c(kernel, "entries", ts.entries, (e, 5), torch.int32), e,
            c(kernel, "w2o", ts.w2o, (ts.w2o.shape[0], 3, 4)))


def packed_operands(kernel: str, ts: TorchScene, link, link_align: int = 8) -> list:
    """Validated device pointers of the link table ``link`` (``(name,
    tensor, shape, dtype)``) that a packed walk follows and of the scene's
    packed node and triangle records: ``[link, nodes, tris]``. Every type
    and shape is checked before any device; a scene without records (or
    without this link table) raises, and so do records that are not 16-byte
    aligned for the kernels' vector loads, or a link table not
    ``link_align``-byte aligned."""
    if ts.packed_nodes is None or ts.packed_tris is None or link[1] is None:
        raise ValueError(f"{kernel}: the scene has no packed records "
                         "(device_scene.with_packed builds them)")
    m = ts.bvh_aabb_min.shape[0]
    t = ts.bvh_tri_v0.shape[0]
    links, nodes, tris = _build.check_operands(kernel, (
        link, ("packed_nodes", ts.packed_nodes, (m, 8), torch.float32),
        ("packed_tris", ts.packed_tris, (t, 12), torch.float32)))
    if (nodes | tris) % 16 or links % link_align:
        raise ValueError(f"{kernel}: the packed records are not aligned")
    return [links, nodes, tris]


def _packed_build_order(kernel: str, ts: TorchScene):
    """The walk of K10a, K10b, K11a and K11b: the packed records in build
    order, their miss links ``bvh_miss``, ``(nodes, miss, tris)``."""
    miss, nodes, tris = packed_operands(
        kernel, ts, ("bvh_miss", ts.bvh_miss, ts.bvh_aabb_min.shape[:1],
                     torch.int32))
    return nodes, miss, tris


def closest_sweep(ts: TorchScene, rays: torch.Tensor, tmin: float,
                  state: torch.Tensor) -> torch.Tensor:
    """Closest hit of ``rays`` (6, P, K) over every entry, merged into
    ``state`` (9, P, K) in place; returns ``state``. CPU tensors take
    :func:`closest_sweep_ref`; CUDA tensors launch ``rt_closest_sweep``."""
    if rays.device.type == "cpu":
        return closest_sweep_ref(ts, rays, tmin, state)
    k = "closest_sweep"
    walk = _packed_build_order(k, ts)
    t = ts.bvh_tri_v0.shape[0]
    _build.launch(
        k,
        *_build.check_planes(k, "rays", rays, (6, *rays.shape[1:])),
        *_build.check_planes(k, "state", state, (9, *rays.shape[1:])),
        rays[0].numel(), float(tmin), *_entries_w2o(k, ts), *walk,
        _build.check_operand(k, "bvh_tri_n_soa", ts.bvh_tri_n_soa, (9, t)), t,
    )
    return state


def anyhit_sweep(ts: TorchScene, rays: torch.Tensor, tmin: float,
                 tmax: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Occlusion of ``rays`` (6, P, K) within ``(tmin, tmax)`` per lane over
    every entry, OR-merged into the int32 ``occ`` (P, K) in place; returns
    ``occ``. CPU tensors take :func:`anyhit_sweep_ref`; CUDA tensors launch
    ``rt_anyhit_sweep``, each lane alone over the packed records in build
    order, as the plain version walks."""
    if rays.device.type == "cpu":
        return anyhit_sweep_ref(ts, rays, tmin, tmax, occ)
    k = "anyhit_sweep"
    walk = _packed_build_order(k, ts)
    _build.launch(
        k,
        *_build.check_planes(k, "rays", rays, (6, *rays.shape[1:])),
        _build.check_operand(k, "tmax", tmax, rays.shape[1:]),
        _build.check_operand(k, "occ", occ, rays.shape[1:], torch.int32),
        rays[0].numel(), float(tmin), *_entries_w2o(k, ts), *walk,
    )
    return occ


def _whole_warps(kernel: str, rays: torch.Tensor) -> None:
    """Raise unless the lanes of ``rays`` (6, P, K) are whole warps."""
    if rays[0].numel() % WARP:
        raise ValueError(f"{kernel}: {rays[0].numel()} lanes are not whole "
                         f"warps of {WARP}")


def mesh_closest(ts: TorchScene, mesh, rays: torch.Tensor, tmin: float,
                 tmax: torch.Tensor):
    """Closest hit of the object-space ``rays`` (6, P, K) within ``(tmin,
    tmax)`` per lane against the one mesh ``mesh = (node_base, node_count,
    tri_base)`` (K11a, ``pallas_closest``) -> ``(t, slot, u, v, n)``, each
    (P, K), ``slot`` int32 and mesh-local, ``n`` the object normal. CPU
    tensors take :func:`mesh_closest_ref`; CUDA tensors launch
    ``rt_mesh_closest``."""
    if rays.device.type == "cpu":
        return mesh_closest_ref(ts, mesh, rays, tmin, tmax)
    k = "mesh_closest"
    _whole_warps(k, rays)
    walk = _packed_build_order(k, ts)
    shape = rays.shape[1:]
    out = torch.empty((6, *shape), dtype=torch.float32, device=rays.device)
    slot = torch.empty(shape, dtype=torch.int32, device=rays.device)
    t = ts.bvh_tri_v0.shape[0]
    _build.launch(
        k, *_build.check_planes(k, "rays", rays, (6, *shape)),
        _build.check_operand(k, "tmax", tmax, shape), out.data_ptr(),
        out.stride(0), slot.data_ptr(), rays[0].numel(), float(tmin),
        *(int(x) for x in mesh), *walk,
        _build.check_operand(k, "bvh_tri_n_soa", ts.bvh_tri_n_soa, (9, t)), t)
    return out[0], slot, out[1], out[2], (out[3], out[4], out[5])


def mesh_anyhit(ts: TorchScene, mesh, rays: torch.Tensor, tmin: float,
                tmax: torch.Tensor) -> torch.Tensor:
    """Occlusion of the object-space ``rays`` (6, P, K) within ``(tmin,
    tmax)`` per lane by the one mesh ``mesh`` (K11b, ``pallas_anyhit``) ->
    bool (P, K); a lane with ``tmax <= tmin`` is not live. CPU tensors take
    :func:`mesh_anyhit_ref`; CUDA tensors launch ``rt_mesh_anyhit``, warps
    voting over the packed records in build order, as the plain version's
    groups walk."""
    if rays.device.type == "cpu":
        return mesh_anyhit_ref(ts, mesh, rays, tmin, tmax)
    k = "mesh_anyhit"
    _whole_warps(k, rays)
    walk = _packed_build_order(k, ts)
    shape = rays.shape[1:]
    occ = torch.empty(shape, dtype=torch.int32, device=rays.device)
    _build.launch(
        k, *_build.check_planes(k, "rays", rays, (6, *shape)),
        _build.check_operand(k, "tmax", tmax, shape), occ.data_ptr(),
        rays[0].numel(), float(tmin), *(int(x) for x in mesh), *walk)
    return occ != 0


def kernel_attributes() -> dict:
    """K10a's, K10b's, K11a's and K11b's registers, local bytes, resident
    CTAs and SMs (:func:`raytpu_torch._build.kernel_attributes`)."""
    return _build.kernel_attributes(
        "rt_traverse_attributes",
        ("closest_sweep", "anyhit_sweep", "mesh_closest", "mesh_anyhit"))


def slot_to_prim(ts: TorchScene, mesh, slot: torch.Tensor) -> torch.Tensor:
    """Mesh-local BVH slots of ``mesh`` -> global prim ids, -1 on a miss
    (``traverse_pallas.slot_to_prim`` :403)."""
    tb = int(mesh[2])
    prim = ts.bvh_tri_prim[(tb + slot.clamp_min(0)).long()]
    return torch.where(slot >= 0, prim, -1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _object_rays(ts: TorchScene, inst: int, ow, dw):
    """World -> object for one instance from its 12 w2o scalars
    (traverse_pallas.py:541-554), plus safe inverse directions."""
    m = ts.w2o[inst].reshape(12)
    o = (
        m[0] * ow[0] + m[1] * ow[1] + m[2] * ow[2] + m[3],
        m[4] * ow[0] + m[5] * ow[1] + m[6] * ow[2] + m[7],
        m[8] * ow[0] + m[9] * ow[1] + m[10] * ow[2] + m[11],
    )
    d = (
        m[0] * dw[0] + m[1] * dw[1] + m[2] * dw[2],
        m[4] * dw[0] + m[5] * dw[1] + m[6] * dw[2],
        m[8] * dw[0] + m[9] * dw[1] + m[10] * dw[2],
    )
    return m, o, d, tuple(safe_inverse(x) for x in d)


# bytes of one row of each table a walk reads, for the rows hook of
# :func:`_walk` ("triangle": the v0, e1, e2 rows of one slot)
ROW_BYTES = {"bvh_tri_first": 4, "bvh_tri_count": 4, "bvh_aabb": 24,
             "bvh_miss": 4, "oct_succ": 4, "oct_skip": 4, "triangle": 36,
             "bvh_tri_n_soa": 36}


def _read_rows(counts, table: str, rows: torch.Tensor, n_rows: int) -> None:
    """Mark ``rows`` of ``table`` (``n_rows`` rows) as read, if ``counts``
    has the ``rows`` dict of :func:`_walk`."""
    seen = None if counts is None else counts.get("rows")
    if seen is None:
        return
    if table not in seen:
        seen[table] = torch.zeros(n_rows, dtype=torch.bool, device=rows.device)
    seen[table][rows] = True


def rows_bytes(counts) -> int:
    """The bytes of the distinct table rows a walk read (each row once),
    from the ``rows`` dict of its ``counts``."""
    return sum(int(seen.sum()) * ROW_BYTES[table]
               for table, seen in counts["rows"].items())


def _walk(ts: TorchScene, nb: int, nc: int, tb: int, o, d, d_inv,
          tmin: float, window: torch.Tensor, on_hit, counts=None,
          links=None, groups=None) -> None:
    """Lock-step skip-link walk of one entry's tree for all lanes of ``o``
    (component tuples of (L,) tensors). ``window`` (L,) is the open upper
    bound, updated in place by ``on_hit(lanes, slot, t, u, v, hit)``, which
    also decides whether a lane keeps walking (it returns the lanes that
    stop; a lane that stops tests no more triangles of its leaf). A lane's
    visits and tests happen in the order the CUDA thread makes them, so
    ``counts``, if a dict, receives the kernel's work too:
    node visits (``nodes``) and Moller-Trumbore tests (``tests``); alone,
    the record fetches of K1/K2's pair walk over the same nodes
    (``fetches``: each lane's root, and each inner node it enters, whose
    child-pair record the kernel loads, ``csrc/perlane.cu``); in groups
    the visits and tests the lanes' own walks need (``own_nodes``,
    ``own_tests``). If it
    holds a dict ``rows``, that receives, per table, a bool mask of the rows
    the kernel reads (:data:`ROW_BYTES`; :func:`rows_bytes` sums them).

    Without ``links`` the walk takes build order: an inner node's box hit
    continues at ``node + 1``, a miss or a finished leaf at ``bvh_miss``.
    With ``links = (succ, skip, base)`` it takes flat per-octant tables
    (``ops/mega.octant_links``) at each lane's offset ``base`` (L,): a hit
    continues at ``succ[base + g]``, a miss or a leaf at ``skip[base + g]``
    (``g`` the node's row in the concatenated tables).

    Without ``groups`` each lane walks alone: a leaf's triangles are tested
    on arrival, an inner node descends on the lane's own box test. With
    ``groups`` (L,) int64, the lanes of a group walk as one, the consensus
    walk of ``csrc/walk.cuh`` (``kWarp``): each lane tests the box of every
    node, leaves included, and the group descends, or tests the leaf for
    all its lanes, where any of their boxes hit. A lane that stops leaves
    its group, whose vote it no longer changes.

    A lane's own walk, the walk of a group of that lane alone, visits a
    node while every box of the node's ancestors in the entry hits its
    ray, and tests the leaves whose box hits it: where the group descends
    below an inner node whose box misses the lane's ray, the lane's own
    walk takes the node's skip link and rejoins the group's where the
    group's walk reaches that node (``csrc/walk.cuh``'s ``OwnWalk``)."""
    dev = window.device
    m = ts.bvh_tri_first.shape[0]
    lanes = torch.arange(window.shape[0], device=dev)
    node = torch.zeros_like(lanes)
    rejoin = torch.full_like(lanes, -1)   # where a lane's own walk rejoins
    if groups is not None:
        _, gid = torch.unique(groups, return_inverse=True)
        n_groups = int(gid.max()) + 1
    elif counts is not None:
        counts["fetches"] = counts.get("fetches", 0) + lanes.numel()
    while lanes.numel():
        if counts is not None:
            counts["nodes"] = counts.get("nodes", 0) + lanes.numel()
        g = node + nb
        first = ts.bvh_tri_first[g].long()
        if links is None:
            skip = ts.bvh_miss[g].long()
            succ = node + 1
        else:
            at = links[2][lanes] + g
            skip = links[1][at].long()
            succ = links[0][at].long()
        leaf = first >= 0

        def box(sel):
            li, gi = lanes[sel], g[sel]
            return slab(
                tuple(x[li] for x in o), tuple(x[li] for x in d_inv),
                tuple(ts.bvh_aabb_min[gi, a] for a in range(3)),
                tuple(ts.bvh_aabb_max[gi, a] for a in range(3)),
                tmin, window[li],
            )

        own = None   # a group's lanes whose own walks test this node's leaf
        if groups is None:
            boxed = ~leaf
            go = leaf.clone()
            if bool(boxed.any()):
                go[boxed] = box(boxed)
        else:
            boxed = torch.ones_like(leaf)
            gl = gid[lanes]
            mine_box = box(boxed)
            hits = torch.zeros(n_groups, dtype=torch.int32, device=dev)
            go = hits.index_add_(0, gl, mine_box.int())[gl] > 0
            if counts is not None:
                rejoin = torch.where(rejoin == node, -1, rejoin)
                mine = rejoin < 0
                rejoin = torch.where(mine & go & ~leaf & ~mine_box, skip, rejoin)
                counts["own_nodes"] = counts.get("own_nodes", 0) + int(mine.sum())
                own = mine & mine_box
        descend = go & ~leaf
        test = go & leaf
        nxt = torch.where(descend, succ, skip)
        if counts is not None and groups is None:
            counts["fetches"] += int(descend.sum())

        if counts is not None and "rows" in counts:
            _read_rows(counts, "bvh_tri_first", g, m)
            _read_rows(counts, "bvh_aabb", g[boxed], m)
            _read_rows(counts, "bvh_tri_count", g[test], m)
            if links is None:
                _read_rows(counts, "bvh_miss", g[~descend], m)
            else:
                _read_rows(counts, "oct_skip", at[~descend], links[1].numel())
                _read_rows(counts, "oct_succ", at[descend], links[0].numel())

        stop = torch.zeros_like(leaf)
        if bool(test.any()):
            lf = test.nonzero().squeeze(1)
            ll, f, cnt = lanes[lf], first[lf], ts.bvh_tri_count[g[lf]].long()
            for k in range(ts.leaf_max):
                sel = (k < cnt) & ~stop[lf]
                if not bool(sel.any()):
                    break
                kl, s = ll[sel], tb + f[sel] + k
                if counts is not None:
                    counts["tests"] = counts.get("tests", 0) + kl.numel()
                    _read_rows(counts, "triangle", s, ts.bvh_tri_v0.shape[0])
                if own is not None:
                    counts["own_tests"] = (counts.get("own_tests", 0)
                                           + int(own[lf[sel]].sum()))
                tri = (ts.bvh_tri_v0[s], ts.bvh_tri_e1[s], ts.bvh_tri_e2[s])
                t, u, v, hit = moller_trumbore(
                    tuple(x[kl] for x in o), tuple(x[kl] for x in d),
                    *(tuple(x[:, a] for a in range(3)) for x in tri),
                    tmin, window[kl],
                )
                stop[lf[sel]] |= on_hit(kl, s, t, u, v, hit)

        node = torch.where(stop, torch.full_like(nxt, nc), nxt)
        keep = node != nc
        lanes, node, rejoin = lanes[keep], node[keep], rejoin[keep]


def _closest_walk(ts: TorchScene, nb: int, nc: int, tb: int, o, d, d_inv,
                  tmin: float, win: torch.Tensor, counts=None, links=None,
                  groups=None):
    """One entry's closest-hit walk (:func:`_walk`) for the lanes of ``o``:
    ``win`` falls to each strict improvement, in place. Returns the
    winning BVH slot (-1 where none, int64), u and v per lane."""
    bs = torch.full(win.shape, -1, dtype=torch.long, device=win.device)
    bu = torch.zeros(win.shape, dtype=torch.float32, device=win.device)
    bv = torch.zeros_like(bu)

    def on_hit(kl, s, t, u, v, hit):
        h = kl[hit]
        win[h] = t[hit]
        bs[h] = s[hit]
        bu[h] = u[hit]
        bv[h] = v[hit]
        return torch.zeros_like(hit)

    _walk(ts, nb, nc, tb, o, d, d_inv, tmin, win, on_hit, counts, links,
          groups)
    return bs, bu, bv


def _anyhit_walk(ts: TorchScene, nb: int, nc: int, tb: int, o, d, d_inv,
                 tmin: float, win: torch.Tensor, counts=None, links=None,
                 groups=None) -> torch.Tensor:
    """One entry's occlusion walk (:func:`_walk`) for the lanes of ``o``: a
    lane stops at its first hit. Returns the lanes hit (bool)."""
    found = torch.zeros(win.shape, dtype=torch.bool, device=win.device)

    def on_hit(kl, s, t, u, v, hit):
        found[kl[hit]] = True
        return hit

    _walk(ts, nb, nc, tb, o, d, d_inv, tmin, win, on_hit, counts, links,
          groups)
    return found


def _object_normal(ts: TorchScene, s, u, v, counts=None):
    """The object normal at slots ``s`` and barycentrics ``(u, v)``,
    interpolated from the slot-ordered corner normals as ``w*N0 + u*N1 +
    v*N2``, ``w = 1 - u - v`` (traverse_pallas.py:171-179)."""
    n_soa = ts.bvh_tri_n_soa
    _read_rows(counts, "bvh_tri_n_soa", s, n_soa.shape[1])
    w = 1.0 - u - v
    return [w * n_soa[c, s] + u * n_soa[3 + c, s] + v * n_soa[6 + c, s]
            for c in range(3)]


def _groups(live: torch.Tensor, consensus: int):
    """The consensus walk's group of each live lane: runs of ``consensus``
    consecutive lanes (None, each lane alone, for 0)."""
    return live // consensus if consensus else None


def closest_ref(ts: TorchScene, rays: torch.Tensor, tmin: float,
                state: torch.Tensor, rows, walks=None, links=None,
                slots=None, counts=None, consensus: int = 0) -> torch.Tensor:
    """The plain closest sweep over the entry ``rows`` (inst, mat,
    node_base, node_count, tri_base) in walk order. ``walks`` (E, P*K)
    bool, if given, says which lanes walk which row (others skip it);
    ``links`` (succ, skip, base) with ``base`` (P*K,) per lane, if given,
    replace build order (:func:`_walk`); ``consensus`` > 0 makes each run of
    that many consecutive lanes a group of the consensus walk. ``slots``
    and ``counts`` as for :func:`closest_sweep_ref`."""
    flat = state.reshape(9, -1)  # a copy if state is a strided wave
    rflat = rays.reshape(6, -1)
    live = (flat[ST_T] > tmin).nonzero().squeeze(1)
    if live.numel() == 0:
        return state
    ow = tuple(rflat[c, live] for c in range(3))
    dw = tuple(rflat[3 + c, live] for c in range(3))
    bt = flat[ST_T, live].clone()
    n_lane = live.shape[0]
    dev = rays.device
    improved = torch.zeros(n_lane, dtype=torch.bool, device=dev)
    res_i = torch.zeros((2, n_lane), dtype=torch.int32, device=dev)  # mat, inst
    res_f = torch.zeros((5, n_lane), dtype=torch.float32, device=dev)  # n, u, v
    res_s = torch.zeros(n_lane, dtype=torch.long, device=dev)  # winning slot
    every = torch.arange(n_lane, device=dev)

    for e, (inst, mat, nb, nc, tb) in enumerate(rows):
        sub = every if walks is None else walks[e, live].nonzero().squeeze(1)
        if sub.numel() == 0:
            continue
        m, o, d, d_inv = _object_rays(ts, inst, tuple(x[sub] for x in ow),
                                      tuple(x[sub] for x in dw))
        win = bt[sub]
        bs, bu, bv = _closest_walk(
            ts, nb, nc, tb, o, d, d_inv, tmin, win, counts,
            None if links is None else (*links[:2], links[2][live[sub]]),
            _groups(live[sub], consensus))
        bt[sub] = win

        won = (bs >= 0).nonzero().squeeze(1)
        if won.numel() == 0:
            continue
        w_ = sub[won]
        s, u, v = bs[won], bu[won], bv[won]
        no = _object_normal(ts, s, u, v, counts)
        res_f[0, w_] = m[0] * no[0] + m[4] * no[1] + m[8] * no[2]
        res_f[1, w_] = m[1] * no[0] + m[5] * no[1] + m[9] * no[2]
        res_f[2, w_] = m[2] * no[0] + m[6] * no[1] + m[10] * no[2]
        res_f[3, w_] = u
        res_f[4, w_] = v
        res_i[0, w_] = mat
        res_i[1, w_] = inst
        res_s[w_] = s
        improved[w_] = True

    hit = live[improved]
    flat[ST_T, hit] = bt[improved]
    flat[ST_VALID, hit] = torch.ones_like(hit, dtype=torch.int32).view(torch.float32)
    flat[ST_MAT, hit] = res_i[0, improved].view(torch.float32)
    flat[ST_INST, hit] = res_i[1, improved].view(torch.float32)
    for j, plane in enumerate((ST_NX, ST_NY, ST_NZ, ST_U, ST_V)):
        flat[plane, hit] = res_f[j, improved]
    if slots is not None:
        slots.reshape(-1)[hit] = res_s[improved]
    if flat.data_ptr() != state.data_ptr():
        state.copy_(flat.view(state.shape))
    return state


def anyhit_ref(ts: TorchScene, rays: torch.Tensor, tmin: float,
               tmax: torch.Tensor, occ: torch.Tensor, rows, walks=None,
               links=None, counts=None, consensus: int = 0) -> torch.Tensor:
    """The plain shadow sweep over the entry ``rows`` in walk order; a lane
    stops at its first hit and skips the remaining rows. ``walks``,
    ``links`` and ``consensus`` as for :func:`closest_ref`."""
    oflat = occ.reshape(-1)
    tflat = tmax.reshape(-1)
    rflat = rays.reshape(6, -1)
    pending = (oflat == 0) & (tflat > tmin)
    for e, (inst, _mat, nb, nc, tb) in enumerate(rows):
        lanes = (pending if walks is None else pending & walks[e]).nonzero().squeeze(1)
        if lanes.numel() == 0:
            continue
        ow = tuple(rflat[c, lanes] for c in range(3))
        dw = tuple(rflat[3 + c, lanes] for c in range(3))
        _, o, d, d_inv = _object_rays(ts, inst, ow, dw)
        found = _anyhit_walk(
            ts, nb, nc, tb, o, d, d_inv, tmin, tflat[lanes].clone(), counts,
            None if links is None else (*links[:2], links[2][lanes]),
            _groups(lanes, consensus))
        oflat[lanes[found]] = 1
        pending[lanes[found]] = False
    if oflat.data_ptr() != occ.data_ptr():
        occ.copy_(oflat.view(occ.shape))
    return occ


def closest_sweep_ref(ts: TorchScene, rays: torch.Tensor, tmin: float,
                      state: torch.Tensor, slots=None,
                      counts=None) -> torch.Tensor:
    """Plain PyTorch :func:`closest_sweep` (same function, same tables,
    same operation order as ``rt_closest_sweep``). If given, ``slots``
    (P, K) int64 receives each improved lane's BVH slot, the triangle that
    won (for comparisons with the JAX walks, which report prims), and
    ``counts`` the walk's node visits and triangle tests (:func:`_walk`)."""
    return closest_ref(ts, rays, tmin, state, ts.entry_rows, slots=slots,
                       counts=counts)


def anyhit_sweep_ref(ts: TorchScene, rays: torch.Tensor, tmin: float,
                     tmax: torch.Tensor, occ: torch.Tensor,
                     counts=None) -> torch.Tensor:
    """Plain PyTorch :func:`anyhit_sweep`: a lane stops at its first hit
    and skips the remaining entries. ``counts`` as for
    :func:`closest_sweep_ref`."""
    return anyhit_ref(ts, rays, tmin, tmax, occ, ts.entry_rows,
                      counts=counts)


def _mesh_lanes(rays: torch.Tensor, tmin: float, tmax: torch.Tensor):
    """The live lanes (window above ``tmin``) of a one-mesh walk, their
    rays and inverse directions."""
    rflat = rays.reshape(6, -1)
    live = (tmax.reshape(-1) > tmin).nonzero().squeeze(1)
    o = tuple(rflat[c, live] for c in range(3))
    d = tuple(rflat[3 + c, live] for c in range(3))
    return live, o, d, tuple(safe_inverse(x) for x in d)


def mesh_closest_ref(ts: TorchScene, mesh, rays: torch.Tensor, tmin: float,
                     tmax: torch.Tensor, counts=None, consensus: int = WARP):
    """Plain PyTorch :func:`mesh_closest`: the consensus walk of
    :func:`_walk` over groups of ``consensus`` consecutive lanes (a warp)
    in build order, the same tests in the same order as
    ``rt_mesh_closest``; ``consensus=0`` walks each lane alone, as K10a's
    lanes walk. ``counts`` as for :func:`closest_sweep_ref`."""
    _whole_warps("mesh_closest", rays)
    nb, nc, tb = (int(x) for x in mesh)
    shape, dev = rays.shape[1:], rays.device
    out = torch.zeros((6, rays[0].numel()), dtype=torch.float32, device=dev)
    out[0] = BIG_T
    out[5] = 1.0
    slot = torch.full((rays[0].numel(),), -1, dtype=torch.int32, device=dev)
    live, o, d, d_inv = _mesh_lanes(rays, tmin, tmax)
    if live.numel():
        win = tmax.reshape(-1)[live].clone()
        bs, bu, bv = _closest_walk(ts, nb, nc, tb, o, d, d_inv, tmin, win,
                                   counts, groups=_groups(live, consensus))
        won = (bs >= 0).nonzero().squeeze(1)
        s, u, v = bs[won], bu[won], bv[won]
        lanes = live[won]
        out[0, lanes] = win[won]
        out[1, lanes] = u
        out[2, lanes] = v
        for c, n in enumerate(_object_normal(ts, s, u, v, counts)):
            out[3 + c, lanes] = n
        slot[lanes] = (s - tb).to(torch.int32)
    out = out.reshape(6, *shape)
    return out[0], slot.reshape(shape), out[1], out[2], (out[3], out[4], out[5])


def mesh_anyhit_ref(ts: TorchScene, mesh, rays: torch.Tensor, tmin: float,
                    tmax: torch.Tensor, counts=None,
                    consensus: int = WARP) -> torch.Tensor:
    """Plain PyTorch :func:`mesh_anyhit`: the consensus walk of
    :func:`_walk` over groups of ``consensus`` lanes in build order, as
    ``rt_mesh_anyhit`` walks (``consensus=0``: each lane alone); a lane
    stops at its first hit and leaves its group. ``counts`` as for
    :func:`closest_sweep_ref`."""
    _whole_warps("mesh_anyhit", rays)
    nb, nc, tb = (int(x) for x in mesh)
    occ = torch.zeros(rays[0].numel(), dtype=torch.bool, device=rays.device)
    live, o, d, d_inv = _mesh_lanes(rays, tmin, tmax)
    if live.numel():
        found = _anyhit_walk(ts, nb, nc, tb, o, d, d_inv, tmin,
                             tmax.reshape(-1)[live].clone(), counts,
                             groups=_groups(live, consensus))
        occ[live[found]] = True
    return occ.reshape(rays.shape[1:])
