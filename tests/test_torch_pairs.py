"""K1/K2's child-pair records (``device_scene.pack_pairs``) and the pair
walk of ``csrc/perlane.cu`` over them, on the CPU.

The kernels cannot run here, so their walk is emulated lane by lane in
Python, step for step as ``pair_walk`` makes it, with the port's own slab
and Moller-Trumbore tests on one-lane tensors:

* walked with every box hit, the pair records reach the nodes in the
  preorder of ``ops/mega.octant_links`` for each of the 8 octants, on
  random trees, the teapot and armadillo stand-ins and a tree that is one
  leaf; the stack never holds more than ``TorchScene.pair_depth`` entries,
  the inner levels of the deepest tree;
* on the three-material scene (the port's trees and raytpu's chunked
  ones), the emulated K1 and K2 give the plain per-lane walks' state and
  flags bit for bit, and the counting walk counts their node visits,
  triangle tests and record fetches exactly (the plain walk counts
  ``fetches`` too), with and without the count-only entries the counting
  walk pushes for boxes that missed.
"""

import types

import numpy as np
import pytest
import torch

from raytpu.render import Renderer as JaxRenderer
from raytpu_torch import scenes
from raytpu_torch.accel.bvh import build_bvh
from raytpu_torch.device_scene import from_raytpu, pack_pairs
from raytpu_torch.ops import intersect, perlane, traverse
from raytpu_torch.ops.mega import OCTANTS, octant_links
from raytpu_torch.render import Renderer
from tests.torch_twin import cone_rays, one_thread, raytpu_twin

TMIN = 1e-3
I32 = torch.int32


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _tree(n_tris: int, seed: int):
    """A one-tree scene's tables (what ``pack_pairs`` reads) of ``n_tris``
    random small triangles, as ``tests/test_perlane.py::_random_chunk``
    makes them, with its octant links."""
    rng = np.random.RandomState(seed)
    v0 = rng.randn(n_tris, 3).astype(np.float32)
    e1 = rng.randn(n_tris, 3).astype(np.float32) * 0.1
    e2 = rng.randn(n_tris, 3).astype(np.float32) * 0.1
    bvh = build_bvh(v0, e1, e2, leaf_size=4)
    succ, skip = octant_links(bvh.aabb_min, bvh.aabb_max, bvh.tri_first, bvh.miss)
    m = bvh.tri_first.shape[0]
    t = torch.from_numpy
    return types.SimpleNamespace(
        bvh_aabb_min=t(bvh.aabb_min), bvh_aabb_max=t(bvh.aabb_max),
        bvh_tri_first=t(bvh.tri_first), bvh_tri_count=t(bvh.tri_count),
        bvh_miss=t(bvh.miss), oct_succ=t(succ), oct_skip=t(skip),
        entry_rows=((0, 0, 0, m, 0),), leaf_max=int(bvh.tri_count.max()))


@pytest.fixture(scope="module", params=["random", "standins", "one_leaf"])
def trees(request):
    """Tables with their pair records and stack depth: a random tree of 700
    triangles, the config4 stand-in's teapot and armadillo (depth 3), and
    a tree of one triangle, whose root is a leaf."""
    if request.param == "standins":
        ts = Renderer(scenes.config4_standin(depth=3), "cpu").tscene
        return ts, ts.packed_pairs, ts.pair_depth
    ts = _tree(700 if request.param == "random" else 1, seed=0)
    return (ts, *pack_pairs(ts))


def _reach_all(ts, pairs, nb: int, octant: int):
    """The always-hit pair walk of the tree at node base ``nb``: the nodes
    it reaches in order, an inner node as ``("inner", id)`` and a leaf as
    ``("leaf", first, count)``, and the most stack entries it held."""
    words = pairs.view(I32)
    first, count = ts.bvh_tri_first, ts.bvh_tri_count

    def child(w):
        ref, n = int(w[3]), int(w[7])
        return ("leaf", ref, n) if ref >= 0 else ("inner", ~ref)

    it = (("leaf", int(first[nb]), int(count[nb])) if first[nb] >= 0
          else ("inner", 0))
    seen, stack, most = [], [], 0
    while True:
        seen.append(it)
        if it[0] == "inner":
            w = words[nb + it[1]]
            a_word = int(w[7])
            a = child(torch.cat((w[:4], w[4:7], (w[7:8] >> 8))))
            b = child(w[8:16])
            a_near = (a_word >> octant) & 1
            stack.append(b if a_near else a)
            most = max(most, len(stack))
            it = a if a_near else b
            continue
        if not stack:
            return seen, most
        it = stack.pop()


def _preorder(ts, nb: int, nc: int, octant: int):
    """The octant links' always-hit walk of the tree at ``nb``: every node
    once, as :func:`_reach_all` names them."""
    first, count = ts.bvh_tri_first, ts.bvh_tri_count
    out, x = [], 0
    while x != nc:
        g = nb + x
        leaf = bool(first[g] >= 0)
        out.append(("leaf", int(first[g]), int(count[g])) if leaf else ("inner", x))
        x = int((ts.oct_skip if leaf else ts.oct_succ)[octant, g])
    return out


def _height(ts, nb: int, nc: int) -> int:
    """Inner levels of the tree at ``nb``, from its parent links."""
    first, miss = ts.bvh_tri_first[nb:nb + nc], ts.bvh_miss[nb:nb + nc]
    depth = [0] * nc
    levels = 0
    for i in range(nc):
        if first[i] < 0:
            levels = max(levels, depth[i] + 1)
            for c in (i + 1, int(miss[i + 1])):
                depth[c] = depth[i] + 1
    return levels


@pytest.mark.parametrize("octant", range(OCTANTS))
def test_pair_walk_reaches_the_octant_preorder(trees, octant):
    ts, pairs, depth = trees
    heights = []
    for nb, nc in sorted({(r[2], r[3]) for r in ts.entry_rows}):
        seen, most = _reach_all(ts, pairs, nb, octant)
        assert seen == _preorder(ts, nb, nc, octant)
        assert len(seen) == nc
        heights.append(_height(ts, nb, nc))
        assert most <= heights[-1]
    assert depth == max(heights)


def test_one_leaf_tree_has_no_pair_record():
    ts = _tree(1, seed=3)
    pairs, depth = pack_pairs(ts)
    assert ts.bvh_tri_first.tolist() == [0] and depth == 0
    assert pairs.shape == (1, 16) and not pairs.view(I32).any()


# ---------------------------------------------------------------------------
# the kernels' walk, emulated
# ---------------------------------------------------------------------------

def _pair_walk(ts, octant, nb, o, d_inv, win, leaf, counts, counting):
    """``csrc/perlane.cu``'s ``pair_walk`` for one lane (one-lane tensors):
    ``win`` is the window the box tests take (``leaf`` may lower it in
    place); the counting walk (``counting``) keeps the inner children whose
    box missed as count-only entries. Returns whether ``leaf`` ended it."""
    nodes, pairs = ts.packed_nodes, ts.packed_pairs

    def reach(lo, hi, n):
        hit, t_near = intersect.slab_near(
            o, d_inv, tuple(lo[a:a + 1] for a in range(3)),
            tuple(hi[a:a + 1] for a in range(3)), TMIN, win)
        ref = int(lo[3:4].view(I32))
        if ref >= 0:
            return ref, n
        return ref, (t_near if bool(hit) else None)

    counts["fetches"] += 1
    root = nodes[nb]
    it = reach(root[:4], root[4:], int(root[7:8].view(I32)))
    nxt, stack = None, []   # the far child reached right after the near one

    def advance():
        nonlocal it, nxt
        if nxt is not None:
            it, nxt = nxt, None
        elif stack:
            it = stack.pop()
        else:
            return False
        return True

    while True:
        while it[0] < 0:
            counts["nodes"] += 1
            if it[1] is not None and bool(it[1] <= win):
                counts["fetches"] += 1
                r = pairs[nb + ~it[0]]
                a_word = int(r[7:8].view(I32))
                a = reach(r[:4], r[4:8], a_word >> 8)
                b = reach(r[8:12], r[12:], int(r[15:16].view(I32)))
                a_near = (a_word >> octant) & 1
                it, nxt = (a, b) if a_near else (b, a)
                if not (counting or nxt[0] >= 0 or nxt[1] is not None):
                    nxt = None
                if it[0] < 0 and it[1] is not None and nxt is not None:
                    stack.append(nxt)
                    nxt = None
            elif not advance():
                return False
        counts["nodes"] += 1
        if leaf(*it):
            return True
        if not advance():
            return False


def _lanes(rays):
    """Every lane's ray as one-lane tensors, ``(ow, dw)`` of the flat lane."""
    flat = rays.reshape(6, -1)
    return lambda i: (tuple(flat[c, i:i + 1] for c in range(3)),
                      tuple(flat[3 + c, i:i + 1] for c in range(3)))


def _emulated_closest(ts, rays, state, counting):
    """K1 on ``rays`` and the fresh ``state``, emulated lane by lane:
    ``(state, slots, counts)``."""
    rows, walks, links = perlane.plain_schedule(ts, rays, state[0], TMIN, "origin")
    m = ts.bvh_aabb_min.shape[0]
    flat = state.reshape(9, -1).clone()
    slots = torch.full(flat.shape[1:], -1, dtype=torch.long)
    counts = dict.fromkeys(("nodes", "tests", "fetches"), 0)
    ray = _lanes(rays)
    tris = (ts.bvh_tri_v0, ts.bvh_tri_e1, ts.bvh_tri_e2)
    for i in (flat[0] > TMIN).nonzero().squeeze(1).tolist():
        ow, dw = ray(i)
        bt = flat[0, i:i + 1].clone()
        octant = int(links[2][i]) // m
        won = None
        for e, (inst, mat, nb, nc, tb) in enumerate(rows):
            if not walks[e, i]:
                continue
            mm, o, d, d_inv = traverse._object_rays(ts, inst, ow, dw)
            best = []

            def leaf(first, n):
                for k in range(n):
                    s = tb + first + k
                    counts["tests"] += 1
                    t, u, v, hit = intersect.moller_trumbore(
                        o, d, *(tuple(x[s, a:a + 1] for a in range(3)) for x in tris),
                        TMIN, bt)
                    if bool(hit):
                        bt.copy_(t)
                        best[:] = [s, u, v]
                return False

            _pair_walk(ts, octant, nb, o, d_inv, bt, leaf, counts, counting)
            if best:
                won = (mm, mat, inst, *best)
        if won is None:
            continue
        mm, mat, inst, s, u, v = won
        no = traverse._object_normal(ts, torch.tensor([s]), u, v)
        flat[0, i] = bt
        flat[1:4, i] = torch.tensor([1, mat, inst], dtype=I32).view(torch.float32)
        flat[4, i] = mm[0] * no[0] + mm[4] * no[1] + mm[8] * no[2]
        flat[5, i] = mm[1] * no[0] + mm[5] * no[1] + mm[9] * no[2]
        flat[6, i] = mm[2] * no[0] + mm[6] * no[1] + mm[10] * no[2]
        flat[7, i], flat[8, i] = u, v
        slots[i] = s
    return flat.view(state.shape), slots.view(state.shape[1:]), counts


def _emulated_anyhit(ts, rays, tmax, counting):
    """K2 on ``rays`` within ``(TMIN, tmax)``, every flag 0 on entry,
    emulated lane by lane: ``(occ, counts)``."""
    rows, walks, links = perlane.plain_schedule(ts, rays, tmax, TMIN, "light")
    m = ts.bvh_aabb_min.shape[0]
    occ = torch.zeros(tmax.numel(), dtype=I32)
    counts = dict.fromkeys(("nodes", "tests", "fetches"), 0)
    ray = _lanes(rays)
    tris = (ts.bvh_tri_v0, ts.bvh_tri_e1, ts.bvh_tri_e2)
    for i in (tmax.reshape(-1) > TMIN).nonzero().squeeze(1).tolist():
        ow, dw = ray(i)
        tm = tmax.reshape(-1)[i:i + 1]
        octant = int(links[2][i]) // m
        for e, (inst, _mat, nb, nc, tb) in enumerate(rows):
            if not walks[e, i]:
                continue
            _, o, d, d_inv = traverse._object_rays(ts, inst, ow, dw)

            def leaf(first, n):
                for k in range(n):
                    s = tb + first + k
                    counts["tests"] += 1
                    if bool(intersect.moller_trumbore(
                            o, d, *(tuple(x[s, a:a + 1] for a in range(3)) for x in tris),
                            TMIN, tm)[3]):
                        return True
                return False

            if _pair_walk(ts, octant, nb, o, d_inv, tm, leaf, counts, counting):
                occ[i] = 1
                break
    return occ.view(tmax.shape), counts


@pytest.fixture(scope="module", params=["own", "chunked"])
def ts(request):
    """The three-material scene with the port's own trees (3 entries) or
    raytpu's chunked ones (many entries)."""
    if request.param == "own":
        r = Renderer(scenes.mixed_scene(32, 32, 1, 1, depth=3), "cpu")
        r.set_transforms(0.1)
        return r.tscene
    jr = JaxRenderer(raytpu_twin(scenes.mixed_scene(32, 32, 1, 1, depth=2,
                                                    chunk_tris=128)))
    jr.set_transforms(0.1)
    return from_raytpu(jr.device_scene, jr.static, "cpu")


def _sampled(seed: int):
    """4 blocks of 8 packets of 32 lanes (``cone_rays``), every third lane
    left live: the rays and windows."""
    rays, win = (torch.from_numpy(x) for x in cone_rays(4, seed=seed, k=32))
    win.view(-1)[torch.arange(win.numel()) % 3 != 0] = 0.0
    return rays, win


@pytest.mark.parametrize("counting", [True, False], ids=["counting", "plain"])
def test_emulated_closest_pair_walk_equals_the_plain_walk(ts, counting):
    rays, win = _sampled(21)
    st0 = traverse.make_trace_state(win)
    want_slots = torch.full(win.shape, -1, dtype=torch.long)
    want_counts = {}
    want = perlane.perlane_closest_sweep_ref(ts, rays, TMIN, st0.clone(),
                                             slots=want_slots, counts=want_counts)
    got, slots, counts = _emulated_closest(ts, rays, st0.clone(), counting)
    assert torch.equal(got.view(I32), want.view(I32))
    assert torch.equal(slots, want_slots)
    assert (want_slots >= 0).sum() > 20
    if counting:
        assert counts == {k: want_counts[k] for k in ("nodes", "tests", "fetches")}
        assert counts["fetches"] < counts["nodes"]


@pytest.mark.parametrize("counting", [True, False], ids=["counting", "plain"])
def test_emulated_anyhit_pair_walk_equals_the_plain_walk(ts, counting):
    rays, win = _sampled(22)
    tmax = torch.where(win > 0, torch.from_numpy(np.random.default_rng(8).uniform(
        0, 25, win.shape).astype(np.float32)), 0.0)
    want_counts = {}
    want = perlane.perlane_anyhit_sweep_ref(ts, rays, TMIN, tmax,
                                            torch.zeros(win.shape, dtype=I32),
                                            counts=want_counts)
    got, counts = _emulated_anyhit(ts, rays, tmax, counting)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int((tmax > TMIN).sum())
    if counting:
        assert counts == {k: want_counts[k] for k in ("nodes", "tests", "fetches")}
