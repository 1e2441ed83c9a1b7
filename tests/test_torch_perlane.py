"""The per-lane sweeps of the PyTorch port (``raytpu_torch/ops/perlane.py``,
the plain versions of K1 and K2) against the chained sweeps' plain
versions (K10a, K10b), and the per-lane, hybrid and consensus tiers'
frames against the chained tier's, on the CPU; the tier table.

The per-lane tier computes the chained function with another schedule
(block culling, depth- or light-ordered entries, near-first walks with the
block's octant), so the bar is bit for bit: all 9 state planes and every
occlusion flag, on the port's own trees and on raytpu's chunked trees. The
frame bar is the JAX bench's ``tie_check``: per-lane, consensus and
chained frames differ in no pixel, also on the tie-prone scene of two
coincident boxes.
The per-lane plain versions against the JAX chain are in
``test_torch_traverse.py``, the prepass against raytpu's in
``test_torch_mega.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytpu.render import Renderer as JaxRenderer
from raytpu_torch import scenes
from raytpu_torch.device_scene import brute_scene, from_raytpu
from raytpu_torch.integrator import PACKET_K, frame_tier, render_frame
from raytpu_torch.ops import consensus, perlane, traverse
from raytpu_torch.render import Renderer
from tests.torch_twin import cone_rays, one_thread, raytpu_twin

TMIN = 1e-3
T_ANIM = 0.1


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module", params=["own", "chunked"])
def ts(request):
    """The three-material scene with the port's own trees (3 entries) or
    raytpu's chunked ones (many entries)."""
    if request.param == "own":
        r = Renderer(scenes.mixed_scene(32, 32, 1, 1, depth=3), "cpu")
        r.set_transforms(T_ANIM)
        return r.tscene
    jr = JaxRenderer(raytpu_twin(scenes.mixed_scene(32, 32, 1, 1, depth=2,
                                                    chunk_tris=128)))
    jr.set_transforms(T_ANIM)
    return from_raytpu(jr.device_scene, jr.static, "cpu")


def test_closest_plain_matches_chained_bitwise(ts):
    rays, win = (torch.from_numpy(x) for x in cone_rays(4, seed=21))
    st0 = traverse.make_trace_state(win)
    work = {}
    want = traverse.closest_sweep_ref(ts, rays, TMIN, st0.clone(),
                                      counts=work.setdefault("K10a", {}))
    got = perlane.perlane_closest_sweep_ref(ts, rays, TMIN, st0.clone(),
                                            counts=work.setdefault("K1", {}))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    hit = got[traverse.ST_VALID].view(torch.int32) != 0
    assert 0.1 < hit.float().mean() < 0.9
    live = int((win > TMIN).sum())
    # not asserted: the block octant is not every ray's own
    print({k: {n: v / live for n, v in c.items()} for k, c in work.items()},
          "per live ray")


def test_walk_rows_read(ts):
    """The rows hook behind chip_smoke's byte bounds: the distinct table
    rows a plain walk reads lie within the tables, number no more than its
    visits and tests, and reading them leaves the result unchanged. A
    consensus walk reads the box of every node it visits."""
    rays, win = (torch.from_numpy(x) for x in cone_rays(4, seed=21))
    st0 = traverse.make_trace_state(win)
    m, t = ts.bvh_tri_first.shape[0], ts.bvh_tri_v0.shape[0]
    for sweep, links in ((traverse.closest_sweep_ref, {"bvh_miss"}),
                         (perlane.perlane_closest_sweep_ref,
                          {"oct_skip", "oct_succ"}),
                         (consensus.mega_closest_sweep_ref,
                          {"oct_skip", "oct_succ"})):
        counts = {"rows": {}}
        got = sweep(ts, rays, TMIN, st0.clone(), counts=counts)
        want = sweep(ts, rays, TMIN, st0.clone())
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        rows = {k: int(v.sum()) for k, v in counts["rows"].items()}
        assert set(rows) == {"bvh_tri_first", "bvh_aabb", "bvh_tri_count",
                             "triangle", "bvh_tri_n_soa"} | links
        assert 0 < rows["bvh_tri_first"] <= min(m, counts["nodes"])
        if sweep is consensus.mega_closest_sweep_ref:
            assert rows["bvh_aabb"] == rows["bvh_tri_first"]
            assert 0 < rows["bvh_tri_count"] < rows["bvh_tri_first"]
        else:   # every node read is an inner node (box) or a leaf (count)
            assert (rows["bvh_aabb"] + rows["bvh_tri_count"]
                    == rows["bvh_tri_first"])
        assert 0 < rows["triangle"] <= min(t, counts["tests"])
        assert 0 < rows["bvh_tri_n_soa"] <= rows["triangle"]
        assert traverse.rows_bytes(counts) == sum(
            n * traverse.ROW_BYTES[k] for k, n in rows.items())


@pytest.mark.parametrize("order", ["light", "origin"])
def test_anyhit_plain_matches_chained_bitwise(ts, order):
    rays, win = cone_rays(4, seed=22)
    tmax = torch.from_numpy(np.where(
        win > 0, np.random.default_rng(8).uniform(0, 25, win.shape), 0
    ).astype(np.float32))
    rays = torch.from_numpy(rays)
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32)
    occ0[3, ::7] = 1                                  # OR-merge keeps these
    want = traverse.anyhit_sweep_ref(ts, rays, TMIN, tmax, occ0.clone())
    got = perlane.perlane_anyhit_sweep_ref(ts, rays, TMIN, tmax, occ0.clone(),
                                           order)
    assert torch.equal(got, want)
    assert 0.05 < (got != 0).float().mean() < 0.9


def _frames(scene, traversals, **knobs):
    """The frame of ``scene`` under each traversal value, with its tier."""
    out = {}
    for trav in traversals:
        cfg = scene.config.replace(traversal=trav)
        r = Renderer(scenes.load_scene(cfg, meshes=scene.meshes,
                                       skybox=scene.skybox), "cpu")
        r.set_transforms(T_ANIM)
        stats = {}
        rs = dataclasses.replace(r.render_static, **knobs)
        img = render_frame(r.tscene, rs, r.camera_tensor(), stats=stats)
        out[trav] = img, stats["tier"]
    return out


@pytest.mark.parametrize("name", ["mixed", "mixed_origin", "tie"])
def test_perlane_frame_equals_chained_frame(name):
    """The tie check: per-lane, hybrid and consensus frames (and "auto",
    which resolves to the consensus tier on these scenes) equal the
    chained tier's bit for bit, n_diff 0."""
    if name == "tie":
        scene, knobs = scenes.tie_scene(), {}
    else:
        scene = scenes.mixed_scene(64, 48, 2, 3)
        knobs = {"shadow_order": "origin"} if name == "mixed_origin" else {}
    frames = _frames(scene, ("pallas", "perlane", "hybrid", "mega", "auto"),
                     **knobs)
    want, tier = frames["pallas"]
    assert tier == "pallas" and want.std() > 0.05
    for trav in ("perlane", "hybrid", "mega", "auto"):
        got, tier = frames[trav]
        assert tier == {"auto": "mega"}.get(trav, trav)
        n_diff = int((got != want).any(dim=-1).sum())
        assert n_diff == 0, (trav, n_diff)


def test_tier_dispatch():
    ts = Renderer(scenes.two_box_scene(32, 32, 2, 2), "cpu").tscene
    assert (ts.traversal, ts.auto_tier) == ("auto", "mega")
    cases = {("auto", "mega"): "mega", ("auto", "perlane"): "perlane",
             ("perlane", "mega"): "perlane", ("hybrid", "mega"): "hybrid",
             ("hybrid", "perlane"): "hybrid", ("pallas", "perlane"): "pallas",
             ("xla", "perlane"): "xla", ("mega", "perlane"): "mega"}
    for (trav, auto), tier in cases.items():
        t = dataclasses.replace(ts, traversal=trav, auto_tier=auto)
        assert frame_tier(t, 64, PACKET_K) == tier, (trav, auto)
        # not whole blocks of 8: the chained sweeps, but "xla" keeps its loop
        assert frame_tier(t, 60, PACKET_K) == ("xla" if trav == "xla" else "pallas")
    # "brute" walks an attached BVH as "xla" does (raytpu/ops/trace.py:290);
    # a scene without one takes the brute loop whatever its traversal
    assert frame_tier(dataclasses.replace(ts, traversal="brute"), 64,
                      PACKET_K) == "xla"
    assert frame_tier(brute_scene(ts), 64, PACKET_K) == "brute"
    with pytest.raises(ValueError, match="not ported"):
        frame_tier(dataclasses.replace(ts, traversal="bvh"), 64, PACKET_K)
    # spp 1 with bounces, and the stand-ins' triangle counts, go per-lane
    assert Renderer(scenes.two_box_scene(32, 32, 1, 1), "cpu").tscene.auto_tier \
        == "perlane"
    # the tie scene and the config2/config3 stand-ins (2,048 and 3,840
    # packets) take the consensus tier
    for scene, p in ((scenes.tie_scene(), 8),
                     (scenes.config2_standin(16), 2048),
                     (scenes.config3_standin(16), 3840)):
        t = Renderer(scene, "cpu").tscene
        assert (t.traversal, t.auto_tier, frame_tier(t, p, PACKET_K)) \
            == ("auto", "mega", "mega")
    rays = torch.zeros((6, 12, 64))
    for closest, anyhit in (
            (perlane.perlane_closest_sweep, perlane.perlane_anyhit_sweep),
            (consensus.mega_closest_sweep, consensus.mega_anyhit_sweep)):
        with pytest.raises(ValueError, match="whole blocks"):
            closest(ts, rays, TMIN, traverse.make_trace_state(rays[0] + 1))
        with pytest.raises(ValueError, match="whole blocks"):
            anyhit(ts, rays, TMIN, rays[0], rays[0].int())
    # a consensus block must be whole warps: 8 packets of 2 lanes are not
    narrow = torch.zeros((6, 8, 2))
    with pytest.raises(ValueError, match="whole warps"):
        consensus.mega_closest_sweep(
            ts, narrow, TMIN, traverse.make_trace_state(narrow[0] + 1))
    with pytest.raises(ValueError, match="wide links"):
        consensus.mega_anyhit_sweep(
            dataclasses.replace(ts, wide_succ=None), rays[:, :8], TMIN,
            rays[0, :8], rays[0, :8].int())
