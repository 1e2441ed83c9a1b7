"""The packed records and the launch operands of the sweeps that read
them, and of the culled sweeps, on the CPU.

K1 and K2 (``csrc/perlane.cu``) read a scene's roots and triangles as
16-byte records (``TorchScene.packed_nodes``, ``packed_tris``, built by
``device_scene.with_packed`` for the port's own trees and for raytpu's
chunked ones) and each inner node's children as one 64-byte record
(``packed_pairs``; their walk is in ``test_torch_pairs.py``); K8 and K9
(``csrc/consensus.cu``) the same node and triangle records with the wide
links (``packed_wide``); K10a-K11b (``csrc/traverse.cu``) the same node
and triangle records in build order, with ``bvh_miss``. The records must
hold the very bits of the tables they come from, so they are unpacked
here and compared as int32 bit patterns. The kernels against their plain versions are in
``test_torch_cuda.py`` (on the card); the launch operands of K1/K2, K8/K9
and K10a/K11a must refuse tensors that are not on the card, a scene
without records, and tables of the wrong shape or type.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytpu.render import Renderer as JaxRenderer
from raytpu_torch import _build, scenes
from raytpu_torch.device_scene import from_raytpu, pack_links, pack_nodes, pack_tris
from raytpu_torch.ops.mega import OCTANTS
from raytpu_torch.ops import consensus, perlane, traverse
from raytpu_torch.render import Renderer
from tests.torch_twin import cone_rays, raytpu_twin

TMIN = 1e-3
I32 = torch.int32


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


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(I32)


def test_packed_nodes_unpack_bitwise(ts):
    m = ts.bvh_aabb_min.shape[0]
    nodes = ts.packed_nodes
    assert nodes.shape == (m, 8) and nodes.dtype == torch.float32
    assert nodes.is_contiguous() and nodes.stride(0) * 4 == 32  # two 16-byte words
    w = _bits(nodes)
    assert torch.equal(w[:, 0:3], _bits(ts.bvh_aabb_min))
    assert torch.equal(w[:, 3], ts.bvh_tri_first)
    assert torch.equal(w[:, 4:7], _bits(ts.bvh_aabb_max))
    assert torch.equal(w[:, 7], ts.bvh_tri_count)
    leaf = ts.bvh_tri_first >= 0
    assert leaf.any() and (~leaf).any()      # both kinds of record present


@pytest.mark.parametrize("kind", ["wide"])
def test_packed_links_unpack_bitwise(ts, kind):
    """``packed_wide`` holds the wide links of the consensus walk, bit for
    bit."""
    m = ts.bvh_aabb_min.shape[0]
    links, succ, skip = ts.packed_wide, ts.wide_succ, ts.wide_skip
    assert links.shape == (8, m, 2) and links.dtype == I32
    assert links.is_contiguous()
    assert torch.equal(links[..., 0], succ)
    assert torch.equal(links[..., 1], skip)
    # the walk leaves a leaf by its skip word, an inner node by either; the
    # wide links drop interior levels, whose nodes hold the mesh's end node
    # in both words (they are never reached)
    inner = ts.bvh_tri_first < 0
    same = (links[..., 0] == links[..., 1]) & inner
    ends = torch.zeros(m, dtype=I32)
    for _, _, nb, nc, _ in ts.entry_rows:
        ends[nb:nb + nc] = nc
    assert torch.equal(same, (links[..., 0] == ends) & inner)
    assert (inner & ~same).any()


def _children(ts):
    """Each inner node's rows, its children's (a: the next row, b: a's
    ``bvh_miss``) and its tree's node base."""
    m = ts.bvh_aabb_min.shape[0]
    base = torch.zeros(m, dtype=torch.long)
    for _, _, nb, nc, _ in ts.entry_rows:
        base[nb:nb + nc] = nb
    inner = (ts.bvh_tri_first < 0).nonzero().squeeze(1)
    a = inner + 1
    return inner, a, base[inner] + ts.bvh_miss[a].long(), base[inner]


@pytest.mark.parametrize("part", ["boxes", "references"])
def test_pair_records_unpack_bitwise(ts, part):
    """``packed_pairs`` holds, per inner node, its children's boxes bit for
    bit (``bvh_aabb_min``/``max`` rows), a leaf child's first slot and
    count and an inner child's complemented mesh-local id; a leaf's row is
    zero."""
    m = ts.bvh_aabb_min.shape[0]
    pairs = ts.packed_pairs
    assert pairs.shape == (m, 16) and pairs.dtype == torch.float32
    assert pairs.is_contiguous() and pairs.stride(0) * 4 == 64  # four 16-byte words
    w = _bits(pairs)
    inner, a, b, base = _children(ts)
    assert not w[ts.bvh_tri_first >= 0].any()
    counts = (w[inner, 7] >> 8, w[inner, 15])
    for c, col, count in ((a, 0, counts[0]), (b, 8, counts[1])):
        if part == "boxes":
            assert torch.equal(w[inner, col:col + 3], _bits(ts.bvh_aabb_min[c]))
            assert torch.equal(w[inner, col + 4:col + 7], _bits(ts.bvh_aabb_max[c]))
            continue
        leaf = ts.bvh_tri_first[c] >= 0
        assert leaf.any() and (~leaf).any()
        assert torch.equal(w[inner, col + 3][leaf], ts.bvh_tri_first[c][leaf])
        assert torch.equal(count[leaf], ts.bvh_tri_count[c][leaf])
        assert torch.equal(~w[inner, col + 3][~leaf], (c - base)[~leaf].to(I32))
        assert not count[~leaf].any()


@pytest.mark.parametrize("octant", range(OCTANTS))
def test_pair_records_near_child_is_the_octant_links(ts, octant):
    """Bit ``octant`` of an inner node's near byte says that its first
    child is the near one: where the octant links continue on a box hit
    (the ``pick_l`` of ``ops/mega.octant_links``)."""
    inner, a, b, base = _children(ts)
    near = (_bits(ts.packed_pairs)[inner, 7] >> octant) & 1
    succ = ts.oct_succ[octant, inner].long() + base
    assert torch.equal(near == 1, succ == a)
    assert torch.equal(near == 0, succ == b)
    assert (near == 1).any() and (near == 0).any()


def test_packed_tris_unpack_bitwise(ts):
    t = ts.bvh_tri_v0.shape[0]
    tris = ts.packed_tris
    assert tris.shape == (t, 12) and tris.dtype == torch.float32
    assert tris.is_contiguous() and tris.stride(0) * 4 == 48  # three 16-byte words
    w = _bits(tris)
    for c, table in enumerate((ts.bvh_tri_v0, ts.bvh_tri_e1, ts.bvh_tri_e2)):
        assert torch.equal(w[:, 4 * c:4 * c + 3], _bits(table))
        assert (w[:, 4 * c + 3] == 0).all()


def test_packing_keeps_every_bit_pattern():
    """Every int32 pattern survives, NaN payloads, -0.0 and infinities
    included, in the float fields as in the int fields."""
    rng = np.random.default_rng(5)
    m = 257
    raw = rng.integers(-2**31, 2**31, (m, 8), dtype=np.int64).astype(np.int32)
    raw[:4, 0] = [0x7fc00001, -0x7f800000 + 1, -2**31, 0x7f800000]  # NaNs, -0.0, inf
    raw = torch.from_numpy(raw)
    f = raw.view(torch.float32)
    nodes = pack_nodes(f[:, 0:3], f[:, 3:6], raw[:, 6], raw[:, 7])
    assert torch.equal(_bits(nodes), raw[:, [0, 1, 2, 6, 3, 4, 5, 7]])
    tris = pack_tris(f[:, 0:3], f[:, 3:6], f[:, 5:8])
    assert torch.equal(_bits(tris)[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]],
                       raw[:, [0, 1, 2, 3, 4, 5, 5, 6, 7]])
    links = pack_links(raw.T, raw.T.flip(0))
    assert torch.equal(links[..., 0], raw.T) and torch.equal(links[..., 1], raw.T.flip(0))


def test_packed_records_are_scene_constants(ts):
    """A transform update keeps the records (they do not depend on the
    transforms), so they are built once per scene."""
    moved = ts.with_transforms(ts.o2w.numpy(), ts.w2o.numpy())
    for name in ("packed_nodes", "packed_pairs", "packed_wide", "packed_tris"):
        assert getattr(moved, name) is getattr(ts, name)
    assert moved.pair_depth == ts.pair_depth > 0


def _launcher(sweep: str, ts, rays, win):
    """``sweep`` ("K1", "K2", "K8", "K9") alone, as a function of the scene
    it launches on, with the plain prepass's schedule of ``rays`` on
    ``ts``."""
    if sweep in ("K1", "K8"):
        sched = perlane.prepass(ts, rays, win, TMIN, "origin")
        fn = {"K1": perlane.launch_closest, "K8": consensus.launch_closest}[sweep]
        return lambda t: fn(t, rays, TMIN, traverse.make_trace_state(win), sched)
    sched = perlane.prepass(ts, rays, win, TMIN, "light")
    fn = {"K2": perlane.launch_anyhit, "K9": consensus.launch_anyhit}[sweep]
    return lambda t: fn(t, rays, TMIN, win, torch.zeros(win.shape, dtype=I32), sched)


@pytest.mark.parametrize("sweep", ["K1", "K2", "K8", "K9"])
def test_launch_operands_refuse(ts, sweep):
    """The kernel-only launchers refuse CPU tensors, and refuse a scene
    without packed records or with a record table of the wrong shape or
    type before they look at the device: K1/K2 read the child pairs
    ``packed_pairs``, K8/K9 the wide links ``packed_wide``. K1/K2 refuse
    a scene deeper than their walk's stack first."""
    rays, win = (torch.from_numpy(x) for x in cone_rays(1, seed=4, k=32))
    launch = _launcher(sweep, ts, rays, win)
    links = "packed_pairs" if sweep in ("K1", "K2") else "packed_wide"
    _build.reset_launch_counts()
    if sweep in ("K1", "K2"):
        with pytest.raises(ValueError, match="deeper than the pair walk's stack"):
            launch(dataclasses.replace(ts, pair_depth=perlane.PAIR_STACK + 1))
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            launch(dataclasses.replace(ts, pair_depth=perlane.PAIR_STACK))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        launch(ts)
    for name in ("packed_nodes", links, "packed_tris"):
        with pytest.raises(ValueError, match="no packed records"):
            launch(dataclasses.replace(ts, **{name: None}))
    wrong = {"packed_nodes": ts.packed_nodes[:, :7],
             links: getattr(ts, links)[..., :1],
             "packed_tris": ts.packed_tris[:, :9]}
    retyped = {"packed_nodes": ts.packed_nodes.view(I32),
               links: (ts.packed_pairs.double() if links == "packed_pairs"
                       else ts.packed_wide.float()),
               "packed_tris": ts.packed_tris.double()}
    for name, table in wrong.items():
        with pytest.raises(ValueError, match=f"{name} has shape"):
            launch(dataclasses.replace(ts, **{name: table}))
    for name, table in retyped.items():
        with pytest.raises(ValueError, match=f"{name} is torch"):
            launch(dataclasses.replace(ts, **{name: table}))
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def _build_order_launcher(sweep: str, ts):
    """``sweep`` ("K10a", "K10b", "K11a", "K11b") through its wrapper on
    meta rays, which take the kernel's path (only CPU tensors take the plain
    version), as a function of the scene it launches on."""
    rays, win = (torch.from_numpy(x) for x in cone_rays(1, seed=4, k=32))
    state = traverse.make_trace_state(win).to("meta")
    occ = torch.zeros(win.shape, dtype=I32, device="meta")
    rays, win = rays.to("meta"), win.to("meta")
    mesh = ts.entry_rows[0][2:]
    return {
        "K10a": lambda t: traverse.closest_sweep(t, rays, TMIN, state),
        "K10b": lambda t: traverse.anyhit_sweep(t, rays, TMIN, win, occ),
        "K11a": lambda t: traverse.mesh_closest(t, mesh, rays, TMIN, win),
        "K11b": lambda t: traverse.mesh_anyhit(t, mesh, rays, TMIN, win),
    }[sweep]


@pytest.mark.parametrize("sweep", ["K10a", "K10b", "K11a", "K11b"])
def test_build_order_operands_refuse(ts, sweep):
    """K10a, K10b, K11a and K11b refuse a scene without packed records, and
    a packed record table or ``bvh_miss`` of the wrong shape or type, before
    they look at the device; then tables that are not on the card."""
    launch = _build_order_launcher(sweep, ts)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        launch(ts)
    for name in ("packed_nodes", "packed_tris"):
        with pytest.raises(ValueError, match="no packed records"):
            launch(dataclasses.replace(ts, **{name: None}))
    wrong = {"packed_nodes": ts.packed_nodes[:-1],
             "packed_tris": ts.packed_tris[:, :9],
             "bvh_miss": ts.bvh_miss[:-1]}
    retyped = {"packed_nodes": ts.packed_nodes.view(I32),
               "packed_tris": ts.packed_tris.double(),
               "bvh_miss": ts.bvh_miss.long()}
    for name, table in wrong.items():
        with pytest.raises(ValueError, match=f"{name} has shape"):
            launch(dataclasses.replace(ts, **{name: table}))
    for name, table in retyped.items():
        with pytest.raises(ValueError, match=f"{name} is torch"):
            launch(dataclasses.replace(ts, **{name: table}))
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
