"""The per-lane tier's culling prepass of the PyTorch port
(``raytpu_torch/ops/mega.py``) against raytpu's (``raytpu/ops/mega.py``):

* ``octant_links`` on every traversal mesh of a ``from_raytpu`` scene, and
  the scene's ``oct_succ``/``oct_skip`` tables: exact;
* ``block_stats_ref`` against the interpret-mode ``_block_stats`` Pallas
  kernel (K7) on 16 packets with dead lanes, a fully dead block and mixed
  direction signs: all 17 columns exact;
* ``chunk_block_hits`` and ``entry_perm`` on the two-box and the chunked
  three-material scenes, on 40 blocks of seeded rays (so that bit 31 of a
  word is used): ``bits`` and ``octs`` exact, ``depth`` within rtol 1e-6,
  both entry orders equal, and the bitmask a superset of an exact per-lane
  root-box test;
* ``resolve_auto_tier`` on the JAX package's preset table;
* the plain prepass after a transform update (the moved root boxes, the
  new "light" order);
* the host side of the card's one-launch prepass (``block_schedule``: its
  buffers and the operands of its launch), the kernel's stable-rank rule
  against ``torch.argsort``, and the CPU's plain path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.accel import resolve_auto_tier as jax_resolve_auto_tier
from raytpu.ops import mega as jmega
from raytpu.render import Renderer as JaxRenderer
from raytpu_torch import scenes
from raytpu_torch.accel import resolve_auto_tier
from raytpu_torch.device_scene import from_raytpu
from raytpu_torch.ops import mega
from tests.torch_twin import cone_rays, raytpu_twin

K = 1024
TMIN = 1e-3
T_ANIM = 0.1


def _jax_renderer(scene):
    jr = JaxRenderer(raytpu_twin(scene))
    jr.set_transforms(T_ANIM)
    return jr


@pytest.fixture(scope="module", params=["two_box", "mixed_chunked"])
def rig(request):
    """(JAX renderer, the port's scene carried across from it)."""
    if request.param == "two_box":
        scene = scenes.two_box_scene(32, 32, 1, 1)
    else:
        scene = scenes.mixed_scene(32, 32, 1, 1, depth=2, chunk_tris=128)
    jr = _jax_renderer(scene)
    return jr, from_raytpu(jr.device_scene, jr.static, "cpu")


def test_octant_links_match_raytpu(rig):
    jr, ts = rig
    dev, static = jr.device_scene, jr.static
    arrays = [np.asarray(x) for x in (dev.bvh_aabb_min, dev.bvh_aabb_max,
                                      dev.bvh_tri_first, dev.bvh_miss)]
    for b, n in static.mesh_node_ranges:
        got = mega.octant_links(*(a[b:b + n] for a in arrays))
        want = jmega.octant_links(*(a[b:b + n] for a in arrays))
        for g, w, table in zip(got, want, (ts.oct_succ, ts.oct_skip)):
            assert g.dtype == np.int32 and g.shape == (8, n)
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(table[:, b:b + n].numpy(), w)


def test_block_stats_ref_matches_interpret_kernel():
    rays, win = cone_rays(2, seed=11)
    win[8:] = 0.0                                    # block 1 fully dead
    assert (rays[3:, :8] < 0).any() and (rays[3:, :8] > 0).any()
    want = np.asarray(jmega._block_stats(
        jnp.asarray(rays.reshape(6, 16, 8, 128)),
        jnp.asarray(win.reshape(16, 8, 128)), TMIN))
    got = mega.block_stats_ref(torch.from_numpy(rays), torch.from_numpy(win),
                               TMIN).numpy()
    assert got.shape == want.shape == (2, mega.STATS_W)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    live = win[:8] > TMIN
    assert got[0, 16] == live.sum() < 8 * K
    assert got[1, 16] == 0 and (got[1, :3] == 3e38).all()


def _exact_block_hits(ts, rays, win):
    """Per (entry, block): does any live lane's exact slab test (float64)
    hit the entry's world root box?"""
    lo, hi = (x.double().numpy() for x in mega.world_root_boxes(ts))
    pb = rays.shape[1] // 8
    o = rays[:3].reshape(3, pb, -1).astype(np.float64)
    d = rays[3:].reshape(3, pb, -1).astype(np.float64)
    w = win.reshape(pb, -1)
    hits = np.zeros((lo.shape[0], pb), bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        for e in range(lo.shape[0]):
            t0 = (lo[e][:, None, None] - o) * inv
            t1 = (hi[e][:, None, None] - o) * inv
            tn = np.nan_to_num(np.minimum(t0, t1), nan=-np.inf).max(axis=0)
            tf = np.nan_to_num(np.maximum(t0, t1), nan=np.inf).min(axis=0)
            hits[e] = ((np.maximum(tn, TMIN) <= np.minimum(tf, w))
                       & (w > TMIN)).any(axis=1)
    return hits


def test_chunk_block_hits_and_entry_perm_match_raytpu(rig):
    jr, ts = rig
    n_blocks = 40
    rays, win = cone_rays(n_blocks, seed=3)
    jrays = jnp.asarray(rays.reshape(6, -1, 8, 128))
    jwin = jnp.asarray(win.reshape(-1, 8, 128))
    jbits, jocts, jdepth = jmega.chunk_block_hits(
        jr.device_scene, jr.static, jrays, jwin, TMIN)
    bits, octs, depth = mega.chunk_block_hits(
        ts, torch.from_numpy(rays), torch.from_numpy(win), TMIN)

    assert bits.dtype == torch.int32 and bits.shape == (ts.entries.shape[0], 2)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits).view(np.int32))
    np.testing.assert_array_equal(octs.numpy(), np.asarray(jocts))
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-6)
    for order in ("origin", "light"):
        want = jmega.entry_perm(jr.device_scene, jr.static, jdepth, order=order)
        got = mega.entry_perm(ts, depth, order)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), order)

    # conservative: every exact root-box hit is flagged; some blocks cull
    blk = np.arange(n_blocks)
    flagged = (np.asarray(jbits)[:, blk // 32] >> (blk % 32)) & 1
    exact = _exact_block_hits(ts, rays, win)
    assert (flagged.astype(bool) | ~exact).all(), "the prepass dropped a hit"
    assert exact[:, 31].any() and flagged[:, 31].any()    # bit 31 survives
    assert 0 < flagged.sum() < flagged.size
    assert not flagged[:, 5].any()                        # the dead block


@pytest.mark.parametrize("tris,spp,bounces,tier", [
    (333_000, 4, 3, "perlane"),   # config4
    (333_000, 4, 63, "perlane"),  # reference
    (6_332, 1, 3, "perlane"),     # config5
    (6_320, 4, 2, "mega"),        # config2
    (36, 4, 3, "mega"),           # config3
    (12, 1, 0, "mega"),           # config1
])
def test_resolve_auto_tier_table(tris, spp, bounces, tier):
    assert resolve_auto_tier(tris, spp, bounces) == tier
    assert jax_resolve_auto_tier(tris, spp, bounces) == tier


def test_plain_prepass_follows_the_transforms():
    """The plain prepass computes the entries' world root boxes and the
    "light" order from the scene's own transforms at each call: after a
    transform update the boxes move and the order is the new scene's."""
    from raytpu_torch.ops import perlane
    from raytpu_torch.render import Renderer

    r = Renderer(scenes.mixed_scene(32, 32, 1, 1, depth=2), "cpu")
    rays, win = cone_rays(8, seed=5)
    rays, win = torch.from_numpy(rays), torch.from_numpy(win)
    boxes = {}
    for t_anim in (0.1, 0.7):
        r.set_transforms(t_anim)
        ts = r.tscene
        lo, hi = mega.world_root_boxes(ts)
        lp = ts.light_pos
        keys = (torch.minimum(torch.maximum(lp, lo), hi) - lp).square().sum(dim=1)
        perm = torch.argsort(keys, stable=True)
        bits, _, entries = perlane.plain_prepass(ts, rays, win, TMIN, "light")
        want_bits, _, _ = mega.chunk_block_hits(ts, rays, win, TMIN)
        assert torch.equal(entries, ts.entries[perm])
        assert torch.equal(bits, want_bits[perm])
        boxes[t_anim] = lo
    assert not torch.equal(boxes[0.1], boxes[0.7])   # the instances moved


# ---------------------------------------------------------------------------
# the card's one-launch prepass (K7 with the schedule): its host side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_scene():
    """The three-material scene with the port's own trees (3 entries)."""
    from raytpu_torch.render import Renderer

    r = Renderer(scenes.mixed_scene(32, 32, 1, 1, depth=2), "cpu")
    r.set_transforms(T_ANIM)
    return r.tscene


@pytest.mark.parametrize("n_entries,n_blocks", [(3, 40), (41, 32), (2, 1), (3, 0)])
def test_schedule_buffers_are_views_of_one_allocation(n_entries, n_blocks):
    """Outputs and scratch of one launch: the shapes and dtypes the culled
    sweeps and the kernel take, contiguous, side by side in one buffer."""
    parts = mega.schedule_buffers(n_entries, n_blocks, "cpu")
    words = -(-n_blocks // 32)
    shapes = [(n_entries, words), (n_blocks,), (n_entries, 5), (n_entries,), (1,),
              (n_blocks, mega.STATS_W), (n_entries,), (n_entries, n_blocks)]
    dtypes = [torch.int32] * 5 + [torch.float32] * 3
    assert [tuple(t.shape) for t in parts] == shapes
    assert [t.dtype for t in parts] == dtypes
    assert all(t.is_contiguous() for t in parts)
    base = parts[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in parts)
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * 4) for t in parts)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), "views overlap"


def _spy_launch(monkeypatch):
    """Record ``_build.launch``'s calls and let its operands lie on the CPU
    (the layout checks stay)."""
    from raytpu_torch import _build

    calls = []
    monkeypatch.setattr(_build, "_check", _build._check_layout)
    monkeypatch.setattr(_build, "launch", lambda k, *args: calls.append((k, args)))
    return calls


def _check_signature(kernel, args):
    """The arguments fit the C entry point's argument types."""
    import ctypes

    from raytpu_torch import _build

    types = _build._SIGNATURES[kernel][:-1]          # the stream is appended
    assert len(args) == len(types)
    for a, t in zip(args, types):
        if t is ctypes.c_void_p:
            assert a is None or isinstance(a, _build.Pointer), a
        elif t is ctypes.c_float:
            assert isinstance(a, float), a
        else:
            assert isinstance(a, int) and not isinstance(a, _build.Pointer), a


@pytest.mark.parametrize("order", ["origin", "light"])
def test_block_schedule_operands(port_scene, monkeypatch, order):
    """The wrapper's operands: one launch of ``block_stats`` with the
    schedule's pointers; "light" passes the light's position and order 1,
    "origin" order 0 and no light; the outputs are what it returns."""
    ts = port_scene
    rays, win = cone_rays(3, seed=4)
    rays, win = torch.from_numpy(np.ascontiguousarray(rays)), torch.from_numpy(win)
    wave = rays[:, 8:24]                       # a strided wave of 2 blocks
    calls = _spy_launch(monkeypatch)
    sched = mega.block_schedule(ts, wave, win[8:24], TMIN, order)
    assert [k for k, _ in calls] == ["block_stats"]
    args = calls[0][1]
    _check_signature("block_stats", args)
    e = ts.entries.shape[0]
    assert args[0] == wave.data_ptr() and args[1] == rays.stride(0)
    assert args[2] == win[8:24].data_ptr()
    assert args[3:6] == (2, 8 * K, TMIN)
    assert args[6] == sched.stats.data_ptr()
    assert args[7:10] == (e, 1, mega.ORDERS.index(order))
    light = tuple(ts.light[:3]) if order == "light" else (0.0, 0.0, 0.0)
    assert args[10:13] == light
    assert args[13:17] == tuple(t.data_ptr() for t in (
        ts.entries, ts.o2w, ts.bvh_aabb_min, ts.bvh_aabb_max))
    assert args[17] == sched.bits.data_ptr() and args[18] == sched.octs.data_ptr()
    assert args[19] == sched.entries.data_ptr() and args[20] == sched.keys.data_ptr()
    assert all(a is not None for a in args)
    assert sched.bits.shape == (e, 1) and sched.bits.dtype == torch.int32
    assert sched.octs.shape == (2,) and sched.entries.shape == (e, 5)
    assert sched.stats.shape == (2, mega.STATS_W) and sched.keys.shape == (e,)
    with pytest.raises(ValueError, match="entry order"):
        mega.block_schedule(ts, wave, win[8:24], TMIN, "near")


def test_block_schedule_operands_of_no_block(port_scene, monkeypatch):
    """A wave of no packet still makes one launch (its one CTA orders the
    entries): no block, no bit word, outputs of no block."""
    calls = _spy_launch(monkeypatch)
    ts = port_scene
    e = ts.entries.shape[0]
    sched = mega.block_schedule(ts, torch.zeros((6, 0, K)), torch.zeros((0, K)),
                                TMIN, "origin")
    (k, args), = calls
    assert k == "block_stats"
    _check_signature(k, args)
    assert args[3] == 0 and args[7:10] == (e, 0, 0)
    assert sched.bits.shape == (e, 0) and sched.octs.shape == (0,)
    assert sched.stats.shape == (0, mega.STATS_W) and sched.entries.shape == (e, 5)


def _stable_rank(keys):
    """The kernel's rank rule (``csrc/mega.cu`` ``before``), plainly: entry
    i's place is the count of entries j whose key is below its own, or
    equal with j < i; NaN above every number and equal to NaN."""
    def before(a, i, b, j):
        a_nan, b_nan = a != a, b != b
        if a_nan or b_nan:
            return not a_nan or (b_nan and i < j)
        return a < b or (a == b and i < j)

    k = keys.tolist()
    return [sum(before(k[j], j, k[i], i) for j in range(len(k))) for i in range(len(k))]


@pytest.mark.parametrize("keys", [
    [3.0, 1.0, 2.0],
    [1.0, 1.0, 0.5, 1.0, 0.5],                                  # ties keep build order
    [float("nan"), 2.0, float("nan"), -1.0, float("inf")],     # NaN last, in order
    [0.0, -0.0, 0.0, -0.0],                                     # signed zeros tie
    [float("-inf"), 3e38, -3e38, float("inf"), float("nan"), 0.0],
])
def test_stable_rank_rule_matches_argsort(keys):
    keys = torch.tensor(keys, dtype=torch.float32)
    rank = _stable_rank(keys)
    assert sorted(rank) == list(range(len(rank)))
    perm = [0] * len(rank)
    for i, r in enumerate(rank):
        perm[r] = i
    assert perm == torch.argsort(keys, stable=True).tolist()


def test_stable_rank_rule_matches_argsort_on_seeded_ties():
    rng = np.random.default_rng(7)
    for _ in range(20):
        keys = rng.integers(0, 4, 40).astype(np.float32)
        keys[rng.random(40) < 0.2] = np.nan
        t = torch.from_numpy(keys)
        rank = _stable_rank(t)
        perm = np.empty(40, np.int64)
        perm[rank] = np.arange(40)
        assert perm.tolist() == torch.argsort(t, stable=True).tolist()


@pytest.mark.parametrize("order", ["origin", "light"])
@pytest.mark.parametrize("plain", [False, True])
def test_cpu_prepass_takes_the_plain_path(port_scene, monkeypatch, order, plain):
    """CPU tensors run the plain prepass (``prepass``, and
    ``plain_prepass`` itself) and launch nothing: bits and entries in the
    order of ``entry_perm``."""
    from raytpu_torch import _build
    from raytpu_torch.ops import perlane

    def refuse(*args):
        raise AssertionError("the CPU prepass launched a kernel")

    monkeypatch.setattr(_build, "launch", refuse)
    ts = port_scene
    rays, win = cone_rays(40, seed=3)
    rays, win = torch.from_numpy(rays), torch.from_numpy(win)
    fn = perlane.plain_prepass if plain else perlane.prepass
    bits, octs, entries = fn(ts, rays, win, TMIN, order)
    wbits, wocts, depth = mega.chunk_block_hits(ts, rays, win, TMIN)
    perm = mega.entry_perm(ts, depth, order)
    assert torch.equal(bits, wbits[perm]) and torch.equal(octs, wocts)
    assert torch.equal(entries, ts.entries[perm])
    assert bits.shape == (ts.entries.shape[0], 2) and bits.dtype == torch.int32
