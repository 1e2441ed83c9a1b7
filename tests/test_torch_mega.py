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
* the scene's per-transform cache of the root boxes and the "light"
  order.
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


def test_root_boxes_and_light_order_once_per_transform_update():
    """The scene caches what the prepass needs from the transforms alone;
    a transform update is a new scene, which computes them anew."""
    from raytpu_torch.render import Renderer

    r = Renderer(scenes.mixed_scene(32, 32, 1, 1, depth=2), "cpu")
    boxes = {}
    for t_anim in (0.1, 0.7):
        r.set_transforms(t_anim)
        ts = r.tscene
        assert ts.root_boxes is ts.root_boxes
        for got, want in zip(ts.root_boxes, mega.world_root_boxes(ts)):
            assert torch.equal(got, want)
        perm, entries = ts.light_order
        assert torch.equal(perm, mega.entry_perm(ts, None, "light"))
        assert torch.equal(entries, ts.entries[perm])
        boxes[t_anim] = ts.root_boxes[0]
    assert not torch.equal(boxes[0.1], boxes[0.7])   # the instances moved
